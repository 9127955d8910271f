"""Full model: backbone -> head -> FBO -> classifier -> loss (port of
``lfb_tpu/models/model.py``; reference ``lib/models/resnet_video.py:133-351``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from lfb_tpu_torch.models.backbone import Backbone, init_backbone
from lfb_tpu_torch.models.fbo import fbo_forward, init_fbo
from lfb_tpu_torch.models.heads import RoIHead, basic_head
from lfb_tpu_torch.models.layers import Params, dropout, gaussian_init
from lfb_tpu_torch.models.spec import ModelSpec

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def init_params(spec: ModelSpec,
                generator: torch.Generator | None = None) -> Params:
    """The reference initialization, in the Caffe2 layout, on the
    generator's device (without one, a generator on ``cuda`` seeded with 0).
    Same names as ``lfb_tpu.models.init_params``."""
    if generator is None:
        generator = torch.Generator(device='cuda').manual_seed(0)
    params = init_backbone(spec, generator)
    params.update(init_fbo(spec, generator))
    if not spec.lfb_infer_only:
        params['pred_w'] = gaussian_init((spec.num_classes, spec.head_dim),
                                         spec.fc_init_std, generator)
        params['pred_b'] = torch.zeros((spec.num_classes,),
                                       device=generator.device)
    return params


def frozen_param_names(spec: ModelSpec, params: Mapping) -> set:
    """Names excluded from gradient updates (``lfb_tpu`` ``model.py:32-56``):
    affine scale/bias (the reference's ``AffineNdGradient`` emits no
    parameter gradients), BN running statistics, and with
    MODEL.FREEZE_BACKBONE everything but the head."""
    frozen = set()
    for name in params:
        if name.endswith('_bn_rm') or name.endswith('_bn_riv'):
            frozen.add(name)
        elif name.endswith('_bn_s') or name.endswith('_bn_b'):
            is_nl = name.startswith('nonlocal_')
            if spec.nl.use_affine if is_nl else spec.use_affine:
                frozen.add(name)
    if spec.freeze_backbone:
        head_prefixes = ('pred_', 'lfb_nl', 'lfb_1x1')
        for name in params:
            if not name.startswith(head_prefixes) and '_fbonl_reduc' not in name:
                frozen.add(name)
    return frozen


class LFBModel(nn.Module):
    """The model.  ``params`` is the flat ``{caffe2_name: tensor}`` mapping;
    it stays reachable, unchanged, as ``model.params``, which the
    inference call ``model(batch)`` reads.  :meth:`run` takes any mapping,
    so training can pass tensors that carry gradients."""

    def __init__(self, spec: ModelSpec,
                 params: Mapping[str, torch.Tensor] | None = None):
        super().__init__()
        self.spec = spec
        self.params = nn.ParameterDict({
            name: nn.Parameter(value, requires_grad=False)
            for name, value in (params or {}).items()})
        self.backbone = Backbone(spec)
        self.roi_head = RoIHead(spec) if spec.head_type == 'roi' else None

    def forward(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.run(self.params, batch)

    def run(self, p: Mapping[str, torch.Tensor],
            batch: Mapping[str, torch.Tensor], *, train: bool = False,
            generator: torch.Generator | None = None
            ) -> Dict[str, torch.Tensor]:
        """Batch blobs (fixed shapes, as ``lfb_tpu.models.forward``):
          data:      (B, T, H, W, 3) normalized frames, or raw uint8 crops
                     (normalized here, the TPU.DEVICE_NORMALIZE path).
          proposals: AVA only -- (N_box, 5) [batch_idx, x1, y1, x2, y2].
          lfb:       (rows, W, lfb_dim) bank windows, with the FBO.
          labels:    optional (N_box or B, num_classes) multi-hot, or (B,)
                     class ids; gives 'loss'.
          box_mask:  optional (N_box,) 1 for real boxes, 0 for padding.

        Returns 'box_pooled' (AVA) or 'pool5', plus 'logits' and 'prob'
        unless the spec is the bank-extraction (lfb_infer_only) one, and
        'loss' when the batch has labels.  ``train`` turns on dropout, drawn
        from ``generator``.
        """
        spec = self.spec
        x = batch['data']
        if x.dtype == torch.uint8:
            mean = torch.tensor(spec.data_mean, dtype=torch.float32,
                                device=x.device)
            std = torch.tensor(spec.data_std, dtype=torch.float32,
                               device=x.device)
            x = (x.float() / 255.0 - mean) / std
        x = x.to(_DTYPES[spec.compute_dtype])

        feats = self.backbone(p, x, train)
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
            fbo_out = fbo_forward(spec, p, head, batch['lfb'].float(), train,
                                  generator)
            head = torch.cat([head, fbo_out.float()], dim=-1)
        if spec.dropout_rate > 0 and train:
            head = dropout(head, spec.dropout_rate, generator)
        logits = head @ p['pred_w'].t() + p['pred_b']
        out['logits'] = logits
        out['prob'] = (torch.sigmoid(logits) if spec.multi_label
                       else torch.softmax(logits, dim=-1))
        if batch.get('labels') is not None:
            out['loss'] = _loss(spec, logits, batch['labels'],
                                batch.get('box_mask'))
        return out


def forward(spec: ModelSpec, params: Mapping[str, torch.Tensor],
            batch: Mapping[str, torch.Tensor], *, train: bool = False,
            generator: torch.Generator | None = None
            ) -> Dict[str, torch.Tensor]:
    """Functional form of :class:`LFBModel`, as ``lfb_tpu.models.forward``.
    Inference runs under ``torch.inference_mode``; training runs with
    autograd on, so gradients reach whichever ``params`` require them."""
    if not train:
        with torch.inference_mode():
            return LFBModel(spec, params)(batch)
    return LFBModel(spec).run(params, batch, train=True, generator=generator)


def loss_parts(spec: ModelSpec, logits: torch.Tensor, labels: torch.Tensor,
               box_mask: torch.Tensor | None):
    """(numerator sum, denominator count) of the classification loss
    (``lfb_tpu`` ``model.py:139-158``): per-element sigmoid cross-entropy
    weighted by ``box_mask`` for multi-label, softmax cross-entropy for
    single-label."""
    logits = logits.float()
    if spec.multi_label:
        labels = labels.float()
        per_elem = (torch.clamp(logits, min=0) - logits * labels
                    + torch.log1p(torch.exp(-torch.abs(logits))))
        if box_mask is not None:
            w = box_mask.float()[:, None]
            per_elem = per_elem * w
            denom = torch.sum(w) * logits.shape[-1]
        else:
            denom = torch.tensor(float(per_elem.numel()), device=logits.device)
        return torch.sum(per_elem), denom
    log_p = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_p, -1, labels.long()[:, None])[:, 0]
    return torch.sum(nll), torch.tensor(float(nll.shape[0]),
                                        device=logits.device)


def _loss(spec: ModelSpec, logits: torch.Tensor, labels: torch.Tensor,
          box_mask: torch.Tensor | None) -> torch.Tensor:
    """The mean classification loss: numerator / max(denominator, 1), with
    no 1/NUM_GPUS factor (``lfb_tpu`` ``model.py:161-173``)."""
    num, den = loss_parts(spec, logits, labels, box_mask)
    return num / torch.clamp(den, min=1.0)

"""Batched scaled-softmax attention: the compute core of the in-backbone
space-time non-local block (reference ``lib/models/nonlocal_helper.py:94-121``)
and of the FBO-NL cross attention over the feature bank (reference
``lib/models/lfb_helper.py:222-234``).  Port of ``lfb_tpu/ops/attention.py``.

    affinity[b, i, j] = <q[b, i, :], k[b, j, :]>
    p = softmax(affinity * scale, axis=-1)
    out[b, i, :] = sum_j p[b, i, j] * v[b, j, :]

Zero-padded bank rows stay in the softmax, as in the reference.  The plain
softmax without a mask goes through
:class:`lfb_tpu_torch.ops.cuda_attention.FusedAttention` on every device: on
a CUDA tensor its forward and backward are the fused kernels, on a CPU
tensor :func:`_attention_plain` (which matches
``lfb_tpu.ops.attention._attention_xla`` in every dtype) and the backward
kernel's plain version.  The mean path (NONLOCAL.USE_SOFTMAX False) and the
masked path are other functions and stay plain autograd.
"""

from __future__ import annotations

import torch

from lfb_tpu_torch.ops import cuda_attention


def scaled_softmax_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, scale: float | None = None,
                             mask: torch.Tensor | None = None,
                             use_softmax: bool = True) -> torch.Tensor:
    """Attention over (B, Nq, C) queries and (B, Nk, C) keys/values.

    ``mask`` is an optional (B, Nk) or (B, Nq, Nk) boolean; False keys get
    -1e30.  ``use_softmax=False`` is the reference's mean aggregation,
    p = affinity / Nk (``lib/models/nonlocal_helper.py:107-117``).
    """
    if use_softmax and mask is None:
        return cuda_attention.FusedAttention.apply(
            q, k, v, 1.0 if scale is None else float(scale))
    return _attention_plain(q, k, v, scale=scale, mask=mask,
                            use_softmax=use_softmax)


def _attention_plain(q, k, v, *, scale, mask, use_softmax, round_p=True):
    """Port of ``lfb_tpu.ops.attention._attention_xla``: f32 logits, the
    probabilities rounded to promote(q.dtype, bf16) before p.V.
    ``round_p=False`` keeps p in f32, as the f32 CUDA kernels do (the bf16
    ones round p to bf16 before p.V, as ``round_p=True`` does)."""
    compute = torch.promote_types(q.dtype, torch.bfloat16)
    logits = torch.matmul(q.float(), k.float().transpose(1, 2))
    if scale is not None:
        logits = logits * scale
    if use_softmax:
        if mask is not None:
            if mask.dim() == 2:
                mask = mask[:, None, :]
            logits = torch.where(mask, logits, torch.tensor(
                -1e30, dtype=torch.float32, device=logits.device))
        p = torch.softmax(logits, dim=-1)
    else:
        p = logits / k.shape[1]
    if round_p:
        p = p.to(compute)
    out = torch.matmul(p.float(), v.to(compute).float())
    return out.to(q.dtype)

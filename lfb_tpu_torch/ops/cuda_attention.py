"""Fused softmax attention: CUDA kernel (``csrc/attention.cu``) and its
plain PyTorch version.

Replaces ``lfb_tpu/ops/pallas_attention.py:_fwd_call`` (kernel
``_attn_kernel``), forward only.  softmax(q k^T * scale) v with no mask,
math in f32, output in q's dtype.

What bounds it on an H100: the in-backbone non-local calls are matmul-sized
(res3: 64 x 4096 x 1024 x 256, res4: 16 x 4096 x 1024 x 512, bf16), so the
limit is arithmetic; this first kernel does it on the f32 FMA units out of
shared memory (tensor cores via ``wgmma`` are later work).  Its design keeps
the (Nq, Nk) affinity out of device memory: one CTA per 32-query tile
streams K/V tiles through shared memory with an online softmax.  The FBO-NL
calls (Nq = 1, Nk = 300, C = 512, f32) are bound by reading K and V once;
they get their own launch shape, one CTA per box.

The TPU kernel's envelope (C % 128 == 0, K/V <= 6 MB) is gone.  The kernel
takes C a multiple of 32 up to 512 when Nq > 1, and any C and Nk whose
(C + Nk) floats fit shared memory when Nq == 1; the wrapper raises on
anything else.
"""

from __future__ import annotations

import torch

from lfb_tpu_torch.ops import attention, cuda_build

# Launches of the CUDA kernel since the last reset (the chip smoke reads it).
LAUNCHES = 0

MAX_C = 512
_SMEM_BYTES = 227 * 1024
_LAUNCHERS = {torch.float32: 'lfb_attention_f32',
              torch.bfloat16: 'lfb_attention_bf16'}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """The kernel's math in plain PyTorch: the unmasked softmax of
    ``attention._attention_plain`` with p kept in f32, output in q's dtype."""
    return attention._attention_plain(q, k, v, scale=scale, mask=None,
                                      use_softmax=True, round_p=False)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """(B, Nq, C) x (B, Nk, C) -> (B, Nq, C).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    scale = 1.0 if scale is None else float(scale)
    if q.device.type == 'cpu':
        return attention_plain(q, k, v, scale)
    _check(q, k, v)
    B, Nq, C = q.shape
    Nk = k.shape[1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        cuda_build.launch(_LAUNCHERS[q.dtype], q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), out.data_ptr(), B, Nq, Nk, C, scale)
    global LAUNCHES
    LAUNCHES += 1
    return out


def _check(q, k, v) -> None:
    for name, t in (('q', q), ('k', k), ('v', v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError('fused_attention: {} must be on {} (got {})'.format(
                name, q.device, t.device))
        if t.dtype != q.dtype or t.dtype not in _LAUNCHERS:
            raise ValueError('fused_attention: q, k, v must all be float32 or '
                             'bfloat16 (got {}, {}, {})'.format(
                                 q.dtype, k.dtype, v.dtype))
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError('fused_attention: {} must be a contiguous '
                             '(B, N, C) tensor'.format(name))
    B, Nq, C = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != C:
        raise ValueError('fused_attention: shapes q {} k {} v {} do not '
                         'match'.format(tuple(q.shape), tuple(k.shape),
                                        tuple(v.shape)))
    Nk = k.shape[1]
    if min(B, Nq, Nk, C) < 1 or B > 65535:
        raise ValueError('fused_attention: unsupported shape q {} k {}'.format(
            tuple(q.shape), tuple(k.shape)))
    if Nq == 1:
        if (C + Nk) * 4 > _SMEM_BYTES:
            raise ValueError('fused_attention: Nq == 1 takes (C + Nk) * 4 <= '
                             '{} bytes (C={}, Nk={})'.format(_SMEM_BYTES, C, Nk))
    elif C % 32 or C > MAX_C:
        raise ValueError('fused_attention: C must be a multiple of 32 and at '
                         'most {} (got {})'.format(MAX_C, C))

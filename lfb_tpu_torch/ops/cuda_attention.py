"""Fused softmax attention: CUDA kernels (``csrc/attention.cu``,
``csrc/attention_bwd.cu``), their plain PyTorch versions, and the autograd
Function that joins them.

Forward: replaces ``lfb_tpu/ops/pallas_attention.py:_fwd_call`` (kernel
``_attn_kernel``).  softmax(q k^T * scale) v with no mask, math in f32,
output in q's dtype, and on request the f32 row log-sum-exp.  Backward:
replaces ``pallas_attention.py:_bwd_call`` (kernel ``_attn_bwd_kernel``):
dq, dk, dv in f32 from q, k, v, dO, the lse and delta = rowsum(dO * O).

What bounds it on an H100: the in-backbone non-local calls are matmul-sized
(a phase-B forward at B = 16: res3 64 x 4096 x 1024 x 256, res4 16 x 4096 x
1024 x 512; a train step at B = 8: res3 32 x 3136 x 784 x 256, res4 8 x 3136
x 784 x 512, all bf16), so the limit is the tensor cores.  In bf16 both
directions run on Hopper's ``wgmma`` (bf16 operands, f32 sums) with their
streamed tiles brought into shared memory by TMA: the forward is
FlashAttention-style, one CTA per query tile streaming K/V tiles with an
online softmax, so the (Nq, Nk) affinity never reaches device memory, and
p rounded to bf16 before p.V as lfb_tpu's XLA reference rounds it.  The
backward recomputes p from the lse instead of storing it, and splits the
TPU kernel's cross-tile dk/dv sum into a K/V-major launch (dk, dv) and a
Q-major launch (dq), so no sum crosses CTAs and no atomics run: two calls
give bitwise the same result.  The tensor maps take a 16-byte aligned start
and rows a multiple of 16 bytes, which the wrapper checks.  In f32 (the
whole-model parity checks) both run on the FMA units, as TF32 would not
hold 2e-3 through the model.  The FBO-NL calls
(Nq = 1, Nk = 300, C = 512, f32) are bound by reading K and V once; they get
their own launch shape, one CTA per box, in both directions.

The TPU kernel's envelope (C % 128 == 0, K/V <= 6 MB) is gone.  The kernels
take C a multiple of 32 up to 512 when Nq > 1, and any C and Nk whose
floats fit shared memory when Nq == 1; the wrappers raise on anything else.
An empty batch (B = 0, the FBO of a batch with no real box row) launches
nothing and returns empty tensors.
"""

from __future__ import annotations

import torch

from lfb_tpu_torch.ops import attention, cuda_build
from lfb_tpu_torch.utils.profiling import count

MAX_C = 512
_SMEM_BYTES = 227 * 1024
_LAUNCHERS = {torch.float32: 'lfb_attention_f32',
              torch.bfloat16: 'lfb_attention_bf16'}
_BWD_LAUNCHERS = {torch.float32: 'lfb_attention_bwd_f32',
                  torch.bfloat16: 'lfb_attention_bwd_bf16'}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """The forward kernel's math in plain PyTorch: the unmasked softmax of
    ``attention._attention_plain`` with p kept in f32, output in q's dtype.
    The bf16 kernel rounds p to bf16 before p.V; the two agree within the
    1e-2 of max |plain| that bf16 outputs are held to."""
    return attention._attention_plain(q, k, v, scale=scale, mask=None,
                                      use_softmax=True, round_p=False)


def attention_fwd_lse_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float, *,
                            round_p: bool = False):
    """(out, lse): :func:`attention_plain` and the f32 (B, Nq) row
    log-sum-exp of the scaled logits, both from one q k^T (so a FLOP count
    of this version matches the kernel's work).  ``round_p`` rounds p to the
    compute dtype before p.V, as lfb_tpu's XLA reference does."""
    logits = attention._logits_plain(q, k, scale)
    out = attention._attend_plain(logits, v, dtype=q.dtype, mask=None,
                                  use_softmax=True, round_p=round_p)
    return out, torch.logsumexp(logits, dim=-1)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, scale: float):
    """The backward kernel's math in plain PyTorch (f32 matmuls), as
    ``_attn_bwd_kernel``: p = exp(s - lse), ds = p (dO v^T - delta),
    dq = ds k * scale, dk = ds^T q * scale, dv = p^T dO.  Returns f32."""
    q, k, v, do = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.matmul(q, k.transpose(1, 2)) * scale - lse[..., None])
    ds = p * (torch.matmul(do, v.transpose(1, 2)) - delta[..., None])
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(1, 2), q) * scale
    dv = torch.matmul(p.transpose(1, 2), do)
    return dq, dk, dv


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None) -> torch.Tensor:
    """(B, Nq, C) x (B, Nk, C) -> (B, Nq, C).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    scale = 1.0 if scale is None else float(scale)
    if q.device.type == 'cpu':
        return attention_plain(q, k, v, scale)
    return _forward(q, k, v, scale, with_lse=False)[0]


def fused_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float) -> tuple:
    """(out, lse): :func:`fused_attention` and the f32 (B, Nq) row
    log-sum-exp the backward needs."""
    if q.device.type == 'cpu':
        return attention_fwd_lse_plain(q, k, v, float(scale))
    return _forward(q, k, v, float(scale), with_lse=True)


def _forward(q, k, v, scale, *, with_lse):
    _check(q, k, v)
    B, Nq, C = q.shape
    Nk = k.shape[1]
    out = torch.empty_like(q)
    lse = (torch.empty((B, Nq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B == 0:                          # no row: a grid of 0 CTAs is refused
        return out, lse
    with torch.cuda.device(q.device):
        cuda_build.launch(_LAUNCHERS[q.dtype], q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), out.data_ptr(),
                          lse.data_ptr() if with_lse else None, B, Nq, Nk, C,
                          scale)
    count('kernel.attention.fwd')
    return out, lse


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, *, scale: float) -> tuple:
    """(dq, dk, dv) in f32 from the forward's inputs, the output gradient
    ``do`` (q's dtype), the f32 (B, Nq) ``lse`` and ``delta``.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernels or raises."""
    scale = float(scale)
    if q.device.type == 'cpu':
        return attention_bwd_plain(q, k, v, do, lse, delta, scale)
    _check(q, k, v, do=do, lse=lse, delta=delta)
    B, Nq, C = q.shape
    Nk = k.shape[1]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    if B == 0:
        return dq, dk, dv
    with torch.cuda.device(q.device):
        cuda_build.launch(_BWD_LAUNCHERS[q.dtype], q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                          delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                          dv.data_ptr(), B, Nq, Nk, C, scale)
    count('kernel.attention.bwd')
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """Differentiable fused attention, as lfb_tpu's custom VJP
    (``pallas_attention.py:194-213``): the forward saves q, k, v, out and
    the lse; the backward forms delta = rowsum(dO * O) in f32 and returns
    dq, dk, dv in the inputs' dtypes.  On the CPU the forward is lfb_tpu's
    XLA reference (p rounded as ``_attention_xla`` rounds it) and the
    backward the plain version of the backward kernel; on CUDA both are the
    kernels.  The kernel writes the lse only when an input needs a
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        needs_grad = any(ctx.needs_input_grad[:3])
        if q.device.type == 'cpu':
            out, lse = attention_fwd_lse_plain(q, k, v, scale, round_p=True)
        else:
            out, lse = _forward(q, k, v, scale, with_lse=needs_grad)
        if needs_grad:
            ctx.scale = scale
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1)
        dq, dk, dv = fused_attention_bwd(q, k, v, do, lse, delta,
                                         scale=ctx.scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def _check(q, k, v, do=None, lse=None, delta=None) -> None:
    for name, t in (('q', q), ('k', k), ('v', v), ('do', do)):
        if t is None:
            continue
        if not t.is_cuda or t.device != q.device:
            raise ValueError('fused_attention: {} must be on {} (got {})'.format(
                name, q.device, t.device))
        if t.dtype != q.dtype or t.dtype not in _LAUNCHERS:
            raise ValueError('fused_attention: q, k, v (and dO) must all be '
                             'float32 or bfloat16 (got {} for {}, q {})'.format(
                                 t.dtype, name, q.dtype))
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError('fused_attention: {} must be a contiguous '
                             '(B, N, C) tensor'.format(name))
        if t.dtype == torch.bfloat16 and q.shape[1] > 1 and (
                t.data_ptr() % 16 or t.shape[-1] * t.element_size() % 16):
            raise ValueError('fused_attention: bf16 {} must start on a '
                             '16-byte boundary, its rows a multiple of 16 '
                             'bytes (the TMA tensor maps of the tensor-core '
                             'kernels take nothing else)'.format(name))
    B, Nq, C = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != C or (
            do is not None and do.shape != q.shape):
        raise ValueError('fused_attention: shapes q {} k {} v {} do {} do not '
                         'match'.format(tuple(q.shape), tuple(k.shape),
                                        tuple(v.shape),
                                        None if do is None else tuple(do.shape)))
    for name, t in (('lse', lse), ('delta', delta)):
        if do is not None and (t is None or not t.is_cuda
                               or t.device != q.device
                               or t.dtype != torch.float32
                               or tuple(t.shape) != (B, Nq)
                               or not t.is_contiguous()):
            raise ValueError('fused_attention: {} must be a contiguous float32 '
                             '(B, Nq) tensor on {}'.format(name, q.device))
    Nk = k.shape[1]
    if min(Nq, Nk, C) < 1 or B > 65535:
        raise ValueError('fused_attention: unsupported shape q {} k {}'.format(
            tuple(q.shape), tuple(k.shape)))
    if Nq == 1:
        floats = 2 * (C + Nk) if do is not None else C + Nk
        if floats * 4 > _SMEM_BYTES:
            raise ValueError('fused_attention: Nq == 1 takes {} * 4 <= {} bytes '
                             'of shared memory (C={}, Nk={})'.format(
                                 'C + Nk' if do is None else '2 (C + Nk)',
                                 _SMEM_BYTES, C, Nk))
    elif C % 32 or C > MAX_C:
        raise ValueError('fused_attention: C must be a multiple of 32 and at '
                         'most {} (got {})'.format(MAX_C, C))

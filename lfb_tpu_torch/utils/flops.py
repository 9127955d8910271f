"""Model cost: parameter counts, FLOPs, bytes and the traced op graph (port
of ``lfb_tpu/utils/flops.py``).

``lfb_tpu`` asks XLA for the compiled program's cost.  The port counts the
aten ops that one call of the function runs, traced on fake tensors on the
CPU (``FakeTensorMode``: shapes, dtypes and strides, no storage, no kernel
run), so a count at full width needs neither a card nor memory:

* FLOPs by ``torch.utils.flop_counter.FlopCounterMode``: matmuls,
  convolutions and attention (elementwise ops count 0; XLA counts them too,
  a few percent of this model's total);
* bytes by :class:`ByteCounter`: each aten op's tensor arguments read once
  and its results written once.  These are *unfused* bytes: every op is
  taken to go through device memory, which overstates what a fused program
  moves.

Every tensor argument, a CUDA one included, becomes a fake tensor on the
CPU, so each hand kernel's wrapper takes its plain version (its CPU branch)
and the count is the same whatever computes an op on the card: kernel,
library call or plain version.  Tensors the function makes itself are fake
too; a tensor it closes over is not converted, so pass every tensor as an
argument.  The function must not read a value (``.item()``, ``.numpy()``,
a branch on data): fake tensors hold none.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Mapping

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

logger = logging.getLogger(__name__)

# Ops that allocate without reading or writing an element.
_ALLOCATE = {torch.ops.aten.empty.memory_format,
             torch.ops.aten.empty_strided.default,
             torch.ops.aten.empty_like.default}


def count_params(params: Mapping[str, torch.Tensor]) -> int:
    """Elements over all tensors of a parameter mapping."""
    return int(sum(v.numel() for v in params.values()))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Sums, over the aten ops run under it, the bytes of each op's tensor
    arguments and results.  Views, bare allocations and queries of a
    tensor's metadata (``prim`` ops) move nothing and are not counted."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (func.namespace == 'aten' and not func.is_view
                and func not in _ALLOCATE):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def fake_cpu(mode: FakeTensorMode, tree):
    """``tree`` with every tensor replaced by a fake CPU tensor of ``mode``
    with its shape, strides, dtype and ``requires_grad``."""

    def convert(t):
        if not isinstance(t, torch.Tensor) or (
                isinstance(t, FakeTensor) and t.fake_mode is mode
                and t.device.type == 'cpu'):
            return t
        with mode:
            fake = torch.empty_strided(tuple(t.shape), t.stride(),
                                       dtype=t.dtype, device='cpu')
        return fake.requires_grad_(t.requires_grad)

    return pytree.tree_map(convert, tree)


def cost_analysis(fn: Callable, *args) -> Dict[str, float]:
    """``{'flops': ..., 'bytes accessed': ...}`` of one call ``fn(*args)``,
    the keys of XLA's cost analysis, counted on fake CPU tensors (see the
    module docstring): FLOPs of the matmuls, convolutions and attention,
    and unfused bytes."""
    mode = FakeTensorMode()
    fake_args = fake_cpu(mode, args)
    flops = FlopCounterMode(display=False)
    counter = ByteCounter()
    with mode, flops, counter:
        fn(*fake_args)
    return {'flops': float(flops.get_total_flops()),
            'bytes accessed': float(counter.bytes)}


def log_flops_params(fn: Callable, params: Mapping[str, torch.Tensor],
                     *args) -> Dict[str, float]:
    """:func:`cost_analysis` of ``fn(params, *args)``, logged with the
    parameter count as ``lfb_tpu`` logs it."""
    costs = cost_analysis(fn, params, *args)
    flops = costs.get('flops', float('nan'))
    logger.info('Model: %.2f GFLOPs, %.2fM params',
                flops / 1e9, count_params(params) / 1e6)
    return costs


def save_graph_text(fn: Callable, path: str, *args) -> str:
    """Write the aten graph of one call ``fn(*args)``, traced by
    ``make_fx`` on fake CPU tensors (the counterpart of ``lfb_tpu``'s
    optimized-HLO dump and of the reference's net-proto pbtxt)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    mode = FakeTensorMode()
    fake_args = fake_cpu(mode, args)
    with mode:
        graph = make_fx(fn)(*fake_args)
    with open(path, 'w') as f:
        f.write(graph.print_readable(print_output=False))
    logger.info('Graph saved to %s', path)
    return path

"""The frozen affine with its shortcut and ReLU as one op
(``lfb_tpu_torch/ops/cuda_affine.py``) on the CPU.

* ``affine_act`` against the composition the blocks ran before it
  (``affine_nd``, ``+``, ``F.relu``), bit for bit, forward and backward, for
  every variant: no shortcut, an identity shortcut, an affine (projection)
  shortcut, each with and without the ReLU, in f32 and bf16, on inputs that
  hold NaN, infinities and signed zeros.  The scales and biases get no
  gradient (they are frozen).  On the CPU the op runs its plain versions,
  which the card tests hold the CUDA kernels to bit for bit.
* A non-reentrant checkpoint drops and recomputes what the op saves.
* A tiny backbone forward sends every frozen-affine site (the stem, three a
  bottleneck block, one a non-local block) through the op once, and the
  true-BN path and the fused bottleneck's blocks none.
"""

import pytest

torch = pytest.importorskip('torch')

import torch.nn.functional as F  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from lfb_tpu_torch.config import flagship_cfg  # noqa: E402
from lfb_tpu_torch.models.backbone import Backbone  # noqa: E402
from lfb_tpu_torch.models.model import init_params  # noqa: E402
from lfb_tpu_torch.models.spec import build_spec  # noqa: E402
from lfb_tpu_torch.ops import cuda_affine  # noqa: E402
from lfb_tpu_torch.ops.affine import affine_nd  # noqa: E402
from lfb_tpu_torch.ops.cuda_affine import affine_act  # noqa: E402
from tests.torch_threads import worker_threads  # noqa: E402,F401

SHAPE = (2, 3, 5, 4, 24)
SHORTCUTS = ('none', 'identity', 'affine')
DTYPES = (torch.float32, torch.bfloat16)


def bits(t):
    """The tensor's bit patterns, so NaN payloads and signed zeros count."""
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[t.dtype])


def assert_bitwise(got, want, name=''):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert torch.equal(bits(got), bits(want)), name


def tensor(seed, shape=SHAPE, dtype=torch.float32, special=True):
    """N(0, 1) values with a few NaN, +-inf, +-0 and values that round the
    bf16 products and sums, in ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 3
    if special:
        flat = x.view(-1)
        values = torch.tensor([float('nan'), float('inf'), -float('inf'), 0.0,
                               -0.0, 1e-30, -1e-30, 65504.0])
        picks = torch.randperm(flat.numel(), generator=g)[:len(values)]
        flat[picks] = values[:len(picks)]
    return x.to(dtype)


def vector(seed, c=SHAPE[-1]):
    g = torch.Generator().manual_seed(seed)
    v = torch.randn((c,), generator=g)
    v[0] = -0.0       # a negative zero scale: signed zero products
    return v


def operands(shortcut, dtype):
    x, s, b = tensor(0, dtype=dtype), vector(1), vector(2)
    r = None if shortcut == 'none' else tensor(3, dtype=dtype)
    rs, rb = (vector(4), vector(5)) if shortcut == 'affine' else (None, None)
    return x, s, b, r, rs, rb


def composition(x, s, b, r, rs, rb, relu):
    """What ``models/backbone.py`` ran before the op."""
    h = affine_nd(x, s, b)
    if r is not None:
        h = h + (r if rs is None else affine_nd(r, rs, rb))
    return F.relu(h) if relu else h


def op(x, s, b, r, rs, rb, relu):
    return affine_act(x, s, b, relu=relu, residual=r, residual_scale=rs,
                      residual_bias=rb)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('relu', [True, False])
@pytest.mark.parametrize('shortcut', SHORTCUTS)
def test_forward_is_the_composition_bitwise(shortcut, relu, dtype):
    args = operands(shortcut, dtype)
    got = op(*args, relu)
    want = composition(*args, relu)
    assert_bitwise(got, want)
    assert got.isnan().any()


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('relu', [True, False])
@pytest.mark.parametrize('shortcut', SHORTCUTS)
def test_gradients_are_the_compositions_bitwise(shortcut, relu, dtype):
    x, s, b, r, rs, rb = operands(shortcut, dtype)
    dy = tensor(6, dtype=dtype)
    dy.view(-1)[::7] = 0.0
    grads = {}
    for name, fn in (('op', op), ('composition', composition)):
        leaves = [t.clone().requires_grad_(True) for t in
                  ([x] if r is None else [x, r])]
        y = fn(leaves[0], s, b, leaves[1] if r is not None else None, rs, rb,
               relu)
        grads[name] = torch.autograd.grad(y, leaves, dy)
    for i, (got, want) in enumerate(zip(grads['op'], grads['composition'],
                                        strict=True)):
        assert_bitwise(got, want, ('x', 'residual')[i])


@pytest.mark.parametrize('shortcut', SHORTCUTS)
def test_scales_and_biases_get_no_gradient(shortcut):
    x, s, b, r, rs, rb = operands(shortcut, torch.float32)
    frozen = [v.clone().requires_grad_(True) for v in (s, b)]
    if rs is not None:
        frozen += [v.clone().requires_grad_(True) for v in (rs, rb)]
    x = x.clone().requires_grad_(True)
    y = op(x, frozen[0], frozen[1], r, *(frozen[2:] or (None, None)),
           relu=True)
    got = torch.autograd.grad(y.nan_to_num().sum(), [x] + frozen,
                              allow_unused=True)
    assert got[0] is not None
    assert all(g is None for g in got[1:])


@pytest.mark.parametrize('shortcut', SHORTCUTS)
def test_a_checkpoint_recomputes_what_the_op_saves(shortcut):
    """Under a non-reentrant checkpoint nothing of the op's forward is kept
    (the saved output and scales are dropped and computed again), and the
    gradients are the same bits."""
    x, s, b, r, rs, rb = operands(shortcut, torch.bfloat16)
    dy = tensor(7, dtype=torch.bfloat16, special=False)
    grads = []
    for remat in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in
                  ([x] if r is None else [x, r])]

        def region(*inputs):
            return op(inputs[0], s, b, inputs[1] if r is not None else None,
                      rs, rb, True)

        y = (checkpoint(region, *leaves, use_reentrant=False) if remat
             else region(*leaves))
        grads.append(torch.autograd.grad(y, leaves, dy))
    for got, want in zip(*grads, strict=True):
        assert_bitwise(got, want)


@pytest.mark.parametrize('dtype', DTYPES)
def test_channels_not_a_multiple_of_a_vector(dtype):
    """C of 1 and 13 (the kernel's scalar path on the card)."""
    for c in (1, 13):
        x, r = (tensor(seed, (7, c), dtype) for seed in (0, 1))
        s, b = vector(2, c), vector(3, c)
        assert_bitwise(op(x, s, b, r, None, None, True),
                       composition(x, s, b, r, None, None, True))


# --------------------------------------------------------------------------- #
# The call sites
# --------------------------------------------------------------------------- #

TINY = {'MODEL.DEPTH': 50, 'TRAIN.VIDEO_LENGTH': 8, 'TEST.VIDEO_LENGTH': 8,
        'TRAIN.CROP_SIZE': 32, 'TEST.CROP_SIZE': 32, 'LFB.WINDOW_SIZE': 4,
        'TPU.COMPUTE_DTYPE': 'float32', 'NUM_GPUS': 1}
TRUE_BN = {'MODEL.USE_AFFINE': False, 'NONLOCAL.USE_AFFINE': False,
           'NONLOCAL.USE_BN': True}


def count_sites(monkeypatch, overrides, split, train=False):
    """The op's calls in one backbone forward of a tiny spec, and the spec."""
    calls = []
    plain = cuda_affine.affine_act_plain

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)

    monkeypatch.setattr(cuda_affine, 'affine_act_plain', counted)
    spec = build_spec(flagship_cfg({**TINY, **overrides}), split)
    params = init_params(spec, torch.Generator().manual_seed(0))
    x = torch.randn((1, 8, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        Backbone(spec)(params, x, train=train)
    return len(calls), spec


def nl_count(spec):
    return sum(len(blocks) for blocks in spec.nl_blocks.values())


@pytest.mark.parametrize('split', ['test', 'train'])
def test_every_frozen_affine_site_takes_the_op(monkeypatch, split):
    n, spec = count_sites(monkeypatch, {}, split, train=split == 'train')
    assert spec.use_affine and spec.nl.use_affine and nl_count(spec) > 0
    assert n == 1 + 3 * sum(spec.block_counts) + nl_count(spec)


def test_true_bn_non_local_blocks_keep_their_norm(monkeypatch):
    overrides = {'NONLOCAL.USE_AFFINE': False, 'NONLOCAL.USE_BN': True}
    n, spec = count_sites(monkeypatch, overrides, 'test')
    assert n == 1 + 3 * sum(spec.block_counts)


@pytest.mark.parametrize('split', ['test', 'train'])
def test_true_bn_takes_no_op(monkeypatch, split):
    n, spec = count_sites(monkeypatch, TRUE_BN, split, train=split == 'train')
    assert not spec.use_affine and n == 0


def test_fused_blocks_take_no_op(monkeypatch):
    """With the fused bottleneck each identity block is one fused kernel;
    the stem, the four projection blocks and the non-local blocks still
    take the op."""
    n, spec = count_sites(monkeypatch, {'TPU.PALLAS_BOTTLENECK': True},
                          'test')
    assert spec.use_pallas_bottleneck
    assert n == 1 + 3 * 4 + nl_count(spec)

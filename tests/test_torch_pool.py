"""The channels-last max pool (``lfb_tpu_torch/ops/cuda_pool.py``) on the
CPU: the plain versions of the kernel's arithmetic, which the card tests and
``chip_smoke.py`` hold the CUDA kernels to.

* The forward against ``F.max_pool3d`` at the port's three windows (pool1,
  pool2, the non-local pools), in f32 and bf16, with odd sizes at the padded
  edges, ties, NaN and -inf: the same bits and, through the uint8 offsets,
  the same chosen position as ATen's int64 index.
* The gather-form backward through autograd against ``F.max_pool3d``'s:
  bit for bit in f32 (both sum a position's gradients in output order);
  in bf16 bit for bit where one window claims a position, and where up to
  four do within 2 eps of the sum of the terms' magnitudes: ATen rounds
  each of up to three partial sums to bf16, the plain version the f32 sum
  once, each rounding at most eps / 2 of that magnitude.
* Both against ``lfb_tpu.ops.pooling.max_pool_3d`` (forward and gradient).
* The stem's affine + ReLU + pool1 against ``max_pool_3d(affine_act(x))``.
* Offsets are written only where autograd will ask for the backward, and
  the public wrappers' CPU path is the composition it was.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from lfb_tpu.ops.pooling import max_pool_3d as jax_max_pool_3d  # noqa: E402
from lfb_tpu_torch.models.layers import norm_act  # noqa: E402
from lfb_tpu_torch.ops import cuda_affine, cuda_pool, pooling  # noqa: E402
from tests.torch_threads import worker_threads  # noqa: E402,F401

WINDOWS = {'pool1': ((1, 3, 3), (1, 2, 2), (0, 1, 1)),
           'pool2': ((2, 1, 1), (2, 1, 1), (0, 0, 0)),
           'non_local': ((1, 2, 2), (1, 2, 2), (0, 0, 0))}
# Odd T, H and W: the padded edges and floor mode's dropped last row.
SHAPE = (2, 5, 7, 9, 6)
DTYPES = (torch.float32, torch.bfloat16)


def bits(t):
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[t.dtype])


def assert_bitwise(got, want, name=''):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert torch.equal(bits(got), bits(want)), name


def tensor(seed, shape=SHAPE, dtype=torch.float32, special=True):
    """N(0, 1) values after a ReLU (ties at 0), a few equal positive values,
    and with ``special`` NaN and -inf (written in ``dtype``: ATen's CPU pool
    passes a bf16 value through f32, which re-encodes a NaN that a bulk
    conversion wrote with other bits; its CUDA pool, as the kernel, moves
    the bits)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn(shape, generator=g))
    flat = x.view(-1)
    flat[torch.randperm(flat.numel(), generator=g)[:flat.numel() // 8]] = 1.5
    x = x.to(dtype)
    if special:
        flat = x.view(-1)
        flat[torch.randperm(flat.numel(), generator=g)[:5]] = float('nan')
        flat[torch.randperm(flat.numel(), generator=g)[:5]] = -float('inf')
    return x


def assert_same(got, want):
    """Bit for bit, but for NaN payloads: on the CPU ATen's bf16 pool
    re-encodes each NaN it passes through f32 (the card's moves the bits, as
    the kernel does)."""
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert_bitwise(got[~nan], want[~nan])


def within_two_roundings(got, want, dy, offsets, in_shape, window):
    """|got - want| <= 2 eps (sum of |dy| over the claiming windows)."""
    terms = cuda_pool.max_pool_bwd_plain(dy.abs().float(), offsets,
                                         in_shape, *window)
    err = (got.float() - want.float()).abs()
    assert bool((err <= 2 * torch.finfo(torch.bfloat16).eps * terms).all())


def aten_pool(x, window, indices=False):
    out = F.max_pool3d(x.permute(0, 4, 1, 2, 3), *window,
                       return_indices=indices)
    if indices:
        return out[0].permute(0, 2, 3, 4, 1), out[1].permute(0, 2, 3, 4, 1)
    return out.permute(0, 2, 3, 4, 1)


def flat_index(offsets, in_shape, window):
    """ATen's flat (t, h, w) index of each window offset."""
    (kt, kh, kw), strides, pads = window
    _, T, H, W, _ = in_shape
    o = offsets.long()
    start = [torch.arange(n) * s - p
             for n, s, p in zip(offsets.shape[1:4], strides, pads)]
    t = start[0][:, None, None, None] + o // (kh * kw)
    h = start[1][None, :, None, None] + (o // kw) % kh
    w = start[2][None, None, :, None] + o % kw
    return (t * H + h) * W + w


def claims(offsets, in_shape, window):
    """How many windows claim each input position."""
    idx = flat_index(offsets, in_shape, window)
    B, T, H, W, C = in_shape
    n = torch.zeros((B, C, T * H * W), dtype=torch.int64)
    n.scatter_add_(2, idx.permute(0, 4, 1, 2, 3).reshape(B, C, -1),
                   torch.ones_like(idx).permute(0, 4, 1, 2, 3).reshape(
                       B, C, -1))
    return n.reshape(B, C, T, H, W).permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', WINDOWS)
def test_forward_is_aten_bit_for_bit_with_its_positions(name, dtype):
    window = WINDOWS[name]
    x = tensor(0, dtype=dtype)
    y, offsets = cuda_pool.max_pool_plain(x, *window)
    want, index = aten_pool(x, window, indices=True)
    assert_bitwise(y, want)
    assert offsets.dtype == torch.uint8
    assert int(offsets.max()) < np.prod(window[0])
    assert torch.equal(flat_index(offsets, x.shape, window), index)


def test_an_all_minus_inf_window_keeps_its_first_position():
    """Nothing beats -inf: ATen keeps -inf at the window's first position
    inside the input (not the padding's)."""
    window = WINDOWS['pool1']
    x = torch.full((1, 1, 5, 5, 2), -float('inf'))
    y, offsets = cuda_pool.max_pool_plain(x, *window)
    want, index = aten_pool(x, window, indices=True)
    assert_bitwise(y, want)
    assert torch.equal(flat_index(offsets, x.shape, window), index)
    assert offsets[0, 0, 0, 0, 0] == 4        # (dh, dw) = (1, 1)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', WINDOWS)
def test_backward_matches_aten_autograd(name, dtype):
    window = WINDOWS[name]
    x = tensor(1, dtype=dtype, special=False)
    dy = torch.randn(cuda_pool.out_shape(x.shape, *window),
                     generator=torch.Generator().manual_seed(2)).to(dtype)
    grads = []
    for fn in (lambda t: aten_pool(t, window),
               lambda t: cuda_pool.max_pool(t, *window)):
        leaf = x.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(leaf), leaf, dy)[0])
    want, got = grads
    if dtype == torch.float32:
        assert_bitwise(got, want)
        return
    _, offsets = cuda_pool.max_pool_plain(x, *window)
    many = claims(offsets, x.shape, window) > 1
    assert_bitwise(got[~many], want[~many])
    within_two_roundings(got, want, dy, offsets, x.shape, window)
    if name != 'pool1':
        assert not bool(many.any())    # windows that do not overlap


@pytest.mark.parametrize('name', WINDOWS)
def test_forward_and_gradient_match_lfb_tpu(name):
    window = WINDOWS[name]
    x = np.random.RandomState(3).randn(*SHAPE).astype(np.float32)
    dy = np.random.RandomState(4).randn(
        *cuda_pool.out_shape(SHAPE, *window)).astype(np.float32)
    y_jax, vjp = jax.vjp(lambda a: jax_max_pool_3d(a, *window),
                         jnp.asarray(x))
    leaf = torch.from_numpy(x).requires_grad_(True)
    y = cuda_pool.max_pool(leaf, *window)
    dx, = torch.autograd.grad(y, leaf, torch.from_numpy(dy))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_jax))
    np.testing.assert_allclose(dx.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]),
                               rtol=1e-6, atol=1e-6)


def stem_operands(dtype, special=True):
    x = tensor(5, dtype=dtype, special=special) * 2 - 1
    g = torch.Generator().manual_seed(6)
    scale = torch.randn(SHAPE[-1], generator=g)
    scale[0] = -0.0
    return x, scale, torch.randn(SHAPE[-1], generator=g)


@pytest.mark.parametrize('dtype', DTYPES)
def test_stem_pass_is_the_composition(dtype):
    """affine + ReLU + pool1 in one: the forward bit for bit (NaN payloads
    aside), the gradient of x as the composition's autograd (in bf16 within
    two roundings where several windows claim a position, times |scale|)."""
    window = WINDOWS['pool1']
    x, s, b = stem_operands(dtype)

    def composition(t):
        return pooling.max_pool_3d(
            cuda_affine.affine_act(t, s, b, relu=True), *window)

    def fused(t):
        return cuda_pool.max_pool(t, *window, scale=s, bias=b)

    with torch.no_grad():
        assert_same(fused(x), composition(x))
    x, s, b = stem_operands(dtype, special=False)
    dy = torch.randn(cuda_pool.out_shape(x.shape, *window),
                     generator=torch.Generator().manual_seed(7)).to(dtype)
    grads = []
    for fn in (composition, fused):
        leaf = x.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(leaf), leaf, dy)[0])
    want, got = grads
    if dtype == torch.float32:
        assert_bitwise(got, want)
    else:
        _, offsets = cuda_pool.max_pool_fwd(x, *window, save=True, scale=s,
                                            bias=b)
        within_two_roundings(got, want, dy * s.abs().max(), offsets,
                             x.shape, window)


def test_offsets_are_written_only_for_a_backward(monkeypatch):
    saves = []
    fwd = cuda_pool.max_pool_fwd

    def recorded(*args, save, **kwargs):
        saves.append(save)
        return fwd(*args, save=save, **kwargs)

    monkeypatch.setattr(cuda_pool, 'max_pool_fwd', recorded)
    window = WINDOWS['non_local']
    x = tensor(8, special=False)
    leaf = x.clone().requires_grad_(True)
    assert cuda_pool.max_pool(x, *window).grad_fn is None
    with torch.no_grad():
        assert cuda_pool.max_pool(leaf, *window).grad_fn is None
    y = cuda_pool.max_pool(leaf, *window)
    assert y.grad_fn is not None
    assert saves == [False, False, True]


def test_a_checkpoint_recomputes_the_offsets():
    window = WINDOWS['pool1']
    x = tensor(9, special=False)
    dy = torch.randn(cuda_pool.out_shape(x.shape, *window),
                     generator=torch.Generator().manual_seed(10))
    grads = []
    for wrap in (lambda f, t: f(t),
                 lambda f, t: checkpoint(f, t, use_reentrant=False)):
        leaf = x.clone().requires_grad_(True)
        y = wrap(lambda t: cuda_pool.max_pool(t * 2, *window), leaf)
        grads.append(torch.autograd.grad(y, leaf, dy)[0])
    assert_bitwise(*grads)


@pytest.mark.parametrize('name', WINDOWS)
def test_public_wrapper_keeps_its_cpu_path(monkeypatch, name):
    """On the CPU ``pooling.max_pool_3d`` is ``F.max_pool3d`` as before and
    never reaches the kernel module."""
    def refuse(*args, **kwargs):
        raise AssertionError('the CPU path reached cuda_pool')

    monkeypatch.setattr(cuda_pool, 'max_pool', refuse)
    window = WINDOWS[name]
    x = tensor(11, dtype=torch.bfloat16)
    got = pooling.max_pool_3d(x, *window)
    assert got.is_contiguous()
    assert_bitwise(got, aten_pool(x, window))


def test_stem_wrapper_keeps_its_cpu_path(monkeypatch):
    """On the CPU the stem's ``norm_act(..., pool=)`` is the composition:
    one ``affine_act`` (its plain version) then ``F.max_pool3d``."""
    calls = []
    plain = cuda_affine.affine_act_plain

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)

    monkeypatch.setattr(cuda_affine, 'affine_act_plain', counted)
    monkeypatch.setattr(cuda_pool, 'max_pool', None)
    window = WINDOWS['pool1']
    x, s, b = stem_operands(torch.bfloat16)
    params = {'res_conv1_bn_s': s, 'res_conv1_bn_b': b}
    got = norm_act(params, 'res_conv1_bn', x, use_affine=True, epsilon=1e-5,
                   relu=True, pool=window)
    assert calls == [x.shape]
    assert_bitwise(got, aten_pool(plain(x, s, b, True), window))
    with pytest.raises(ValueError):
        norm_act(params, 'res_conv1_bn', x, use_affine=True, epsilon=1e-5,
                 relu=True, residual=x, pool=window)

"""The port's fused identity bottleneck (``lfb_tpu_torch/ops/cuda_bottleneck.py``)
against lfb_tpu on the CPU.

* ``fused_identity_bottleneck_plain`` against lfb_tpu's Pallas kernel
  ``fused_identity_bottleneck`` run in interpret mode (as
  ``tests/test_pallas_interpret.py`` runs it), f32, rtol and atol 1e-4 (the
  same products summed in other orders; the Pallas test holds its kernel
  to XLA with the same bound).  A case with a large positive branch2a bias,
  where relu(b2a) is far from 0, pins the spatial zero padding of branch2b's
  input.
* bf16 against f32 through the plain version: 1e-2 of the largest output
  (h1, h2 and the output each rounded to bf16, 2^-8 relative).
* ``fold_bottleneck_params`` against lfb_tpu's, after ``params_from_jax``:
  1e-6 (the same f32 products).
* ``kernel_weights``, the weight layout the CUDA kernel streams, against
  lfb_tpu's kernel layouts (exact), and the block computed the way the
  bf16 kernel does (products per temporal tap and per shifted 3 x 3 tap
  over the ``kernel_weights`` matrices) against the plain version: 1e-5.
* The port's ``Bottleneck`` with ``use_pallas_bottleneck`` against lfb_tpu's
  ``_bottleneck`` (the unfused XLA block on the CPU): 1e-4, as above.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lfb_tpu.models as jax_models  # noqa: E402
from lfb_tpu.models.backbone import _bottleneck as jax_bottleneck  # noqa: E402
from lfb_tpu.ops import pallas_bottleneck as pb  # noqa: E402
from lfb_tpu_torch.config import flagship_cfg  # noqa: E402
from lfb_tpu_torch.convert import params_from_jax  # noqa: E402
from lfb_tpu_torch.models.backbone import Bottleneck  # noqa: E402
from lfb_tpu_torch.models.spec import build_spec  # noqa: E402
from lfb_tpu_torch.ops import cuda_bottleneck  # noqa: E402
from lfb_tpu_torch.utils.profiling import counts  # noqa: E402
from tests.test_torch_model import TINY  # noqa: E402

B, T, H, W, C, CI = 2, 4, 8, 8, 128, 32


def block_params(rng, kt, ci=CI, c=C, b2a_shift=0.0):
    """Folded params in lfb_tpu's kernel layouts: w2a (kt, C, Ci), w2b (9,
    Ci, Ci), w2c (Ci, C)."""
    return {'w2a': (rng.randn(kt, c, ci) * 0.1).astype('f'),
            'b2a': (rng.randn(ci) * 0.1 + b2a_shift).astype('f'),
            'w2b': (rng.randn(9, ci, ci) * 0.1).astype('f'),
            'b2b': (rng.randn(ci) * 0.1).astype('f'),
            'w2c': (rng.randn(ci, c) * 0.1).astype('f'),
            'b2c': (rng.randn(c) * 0.1).astype('f')}


def port_layout(p):
    """lfb_tpu's kernel layouts -> the port's conv layouts."""
    kt, c, ci = p['w2a'].shape
    t = torch.from_numpy
    return (t(np.ascontiguousarray(p['w2a'].transpose(2, 1, 0)))[..., None, None],
            t(p['b2a']),
            t(np.ascontiguousarray(
                p['w2b'].reshape(3, 3, ci, ci).transpose(3, 2, 0, 1)))[:, :, None],
            t(p['b2b']),
            t(np.ascontiguousarray(p['w2c'].T))[..., None, None, None],
            t(p['b2c']))


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, 'pallas_call',
                        lambda *a, **k: orig(*a, interpret=True, **k))


@pytest.mark.parametrize('kt,d,b2a_shift', [
    (3, 1, 0.0), (1, 1, 0.0), (1, 2, 0.0),
    (3, 1, 3.0), (1, 2, 3.0),          # relu(b2a) >> 0: the zero padding
])
def test_plain_matches_the_pallas_kernel(interpret, kt, d, b2a_shift):
    rng = np.random.RandomState(kt * 10 + d)
    p = block_params(rng, kt, b2a_shift=b2a_shift)
    x = rng.randn(B, T, H, W, C).astype('f')
    ref = pb.fused_identity_bottleneck(
        jnp.asarray(x), *(jnp.asarray(p[k]) for k in
                          ('w2a', 'b2a', 'w2b', 'b2b', 'w2c', 'b2c')),
        temporal_pad=kt // 2, dilation=d)
    assert ref is not None
    before = counts().get('kernel.bottleneck.fwd', 0)
    out = cuda_bottleneck.fused_identity_bottleneck(
        torch.from_numpy(x), *port_layout(p), temporal_pad=kt // 2,
        dilation=d)
    # the CPU takes plain
    assert counts().get('kernel.bottleneck.fwd', 0) == before == 0
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    if b2a_shift:
        # The border differs from a block that pads relu(b2a) instead of 0.
        wrong = _pad_with_relu_b2a(x, p, kt, d)
        assert np.abs(wrong - np.asarray(ref)).max() > 1e-2


def _pad_with_relu_b2a(x, p, kt, d):
    """The block with branch2b's input padded by relu(b2a), the bug a
    banded kernel that recomputes branch2a on halo rows would have."""
    w2a, b2a, w2b, b2b, w2c, b2c = port_layout(p)
    xt = torch.from_numpy(x)
    h = cuda_bottleneck.conv3d(xt, w2a, padding=(kt // 2, 0, 0))
    h = torch.relu(h + b2a)
    fill = torch.relu(b2a)
    padded = fill.expand(B, T, H + 2 * d, W + 2 * d, CI).clone()
    padded[:, :, d:d + H, d:d + W] = h
    h = cuda_bottleneck.conv3d(padded, w2b, dilation=(1, d, d))
    h = torch.relu(h + b2b)
    h = cuda_bottleneck.conv3d(h, w2c) + b2c
    return torch.relu(h + xt).numpy()


@pytest.mark.parametrize('kt,d', [(3, 1), (1, 2)])
def test_bf16_plain_is_within_its_rounding_of_f32(kt, d):
    rng = np.random.RandomState(3)
    p = port_layout(block_params(rng, kt))
    x = torch.from_numpy(rng.randn(B, T, H, W, C).astype('f'))
    f32 = cuda_bottleneck.fused_identity_bottleneck(
        x, *p, temporal_pad=kt // 2, dilation=d)
    bf16 = cuda_bottleneck.fused_identity_bottleneck(
        x.bfloat16(), *p, temporal_pad=kt // 2, dilation=d)
    assert bf16.dtype == torch.bfloat16
    err = (bf16.float() - f32).abs().max().item()
    assert err <= 1e-2 * f32.abs().max().item()


def _jax_block_params(rng, prefix, kt, c, ci):
    """lfb_tpu-layout params of one bottleneck block, with affine."""
    return {
        prefix + '_branch2a_w': (rng.randn(kt, 1, 1, c, ci) * 0.1).astype('f'),
        prefix + '_branch2b_w': (rng.randn(1, 3, 3, ci, ci) * 0.1).astype('f'),
        prefix + '_branch2c_w': (rng.randn(1, 1, 1, ci, c) * 0.1).astype('f'),
        **{prefix + '_branch2{}_bn_{}'.format(br, sb):
           (rng.randn(n) * 0.5 + (1.0 if sb == 's' else 0.0)).astype('f')
           for br, n in (('a', ci), ('b', ci), ('c', c)) for sb in 'sb'}}


@pytest.mark.parametrize('kt', [1, 3])
def test_fold_matches_lfb_tpu(kt):
    rng = np.random.RandomState(kt)
    jp = _jax_block_params(rng, 'res4_1', kt, 64, 16)
    ref = pb.fold_bottleneck_params(jp, 'res4_1')
    got = cuda_bottleneck.fold_bottleneck_params(params_from_jax(jp, 'cpu'),
                                                 'res4_1')
    w2a, b2a, w2b, b2b, w2c, b2c = got
    as_jax = (w2a.permute(2, 1, 0, 3, 4).reshape(kt, 64, 16), b2a,
              w2b[:, :, 0].permute(2, 3, 1, 0).reshape(9, 16, 16), b2b,
              w2c.reshape(64, 16).t(), b2c)
    for mine, theirs in zip(as_jax, ref, strict=True):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=0,
                                   atol=1e-6)
    assert cuda_bottleneck.fold_bottleneck_params(params_from_jax(jp, 'cpu'),
                                                  'res4_2') is None
    jp['res4_1_branch2a_w'] = np.zeros((kt, 3, 1, 64, 16), 'f')
    assert cuda_bottleneck.fold_bottleneck_params(params_from_jax(jp, 'cpu'),
                                                  'res4_1') is None


@pytest.mark.parametrize('kt', [1, 3])
def test_kernel_weights_are_lfb_tpu_kernel_layouts(kt):
    """``kernel_weights`` (the (K, N) matrices the CUDA kernel streams) of
    the port's conv weights are lfb_tpu's kernel layouts, flattened: w2a
    (kT * C, Ci), w2b (9 * Ci, Ci), w2c (Ci, C); exact."""
    rng = np.random.RandomState(kt + 5)
    p = block_params(rng, kt)
    wa, wb, wc = cuda_bottleneck.kernel_weights(
        *port_layout(p)[0:5:2], torch.float32)
    np.testing.assert_array_equal(wa.numpy(), p['w2a'].reshape(kt * C, CI))
    np.testing.assert_array_equal(wb.numpy(), p['w2b'].reshape(9 * CI, CI))
    np.testing.assert_array_equal(wc.numpy(), p['w2c'])


@pytest.mark.parametrize('kt,d,shape', [
    (3, 1, (B, T, H, W)), (1, 2, (B, T, H, W)), (3, 2, (1, 3, 7, 5))])
def test_block_as_the_kernel_computes_it_matches_the_plain_version(kt, d,
                                                                   shape):
    """The bf16 kernel's formulation on the CPU, in f32: branch2a as one
    product per temporal tap, branch2b as one per (dh, dw) tap over h1
    shifted by (dh d, dw d) with zeros outside the image, branch2c, from the
    matrices of ``kernel_weights``: within 1e-5 of
    ``fused_identity_bottleneck_plain`` (the same sums in other orders)."""
    rng = np.random.RandomState(11)
    p = port_layout(block_params(rng, kt, b2a_shift=1.0))
    x = torch.from_numpy(rng.randn(*shape, C).astype('f'))
    wa, wb, wc = cuda_bottleneck.kernel_weights(p[0], p[2], p[4],
                                                torch.float32)
    b_, t_, h_, w_ = shape
    h1 = torch.zeros(b_, t_, h_, w_, CI)
    for tap in range(kt):
        src = torch.zeros_like(x)
        lo, hi = max(0, kt // 2 - tap), min(t_, t_ + kt // 2 - tap)
        src[:, lo:hi] = x[:, lo + tap - kt // 2:hi + tap - kt // 2]
        h1 += src @ wa[tap * C:(tap + 1) * C]
    h1 = torch.relu(h1 + p[1])
    padded = torch.nn.functional.pad(h1, (0, 0, d, d, d, d))
    h2 = torch.zeros_like(h1)
    for tap in range(9):
        dh, dw = divmod(tap, 3)
        h2 += padded[:, :, dh * d:dh * d + h_, dw * d:dw * d + w_] @ \
            wb[tap * CI:(tap + 1) * CI]
    h2 = torch.relu(h2 + p[3])
    got = torch.relu(h2 @ wc + p[5] + x)
    ref = cuda_bottleneck.fused_identity_bottleneck_plain(
        x, *p, temporal_pad=kt // 2, dilation=d)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('use_temp_conv,d', [(1, 1), (0, 2)])
def test_fused_block_matches_lfb_tpu_bottleneck(monkeypatch, use_temp_conv,
                                                d):
    """The port's Bottleneck takes the fused route (its plain version runs
    once) and matches lfb_tpu's unfused block."""
    cfg = flagship_cfg({**TINY, 'TPU.PALLAS_BOTTLENECK': True})
    jspec = jax_models.build_spec(cfg, 'test')
    spec = build_spec(cfg, 'test')
    assert spec.use_pallas_bottleneck
    rng = np.random.RandomState(7)
    c, ci = 64, 16
    jp = _jax_block_params(rng, 'res5_1', 2 * use_temp_conv + 1, c, ci)
    x = np.abs(rng.randn(2, 4, 6, 6, c)).astype('f')
    ref = jax_bottleneck(jspec, {k: jnp.asarray(v) for k, v in jp.items()},
                         'res5_1', jnp.asarray(x), dim_out=c, stride=1,
                         temp_stride=1, use_temp_conv=use_temp_conv,
                         dilation=d, train=False, bn_updates=None)
    calls = []
    plain = cuda_bottleneck.fused_identity_bottleneck_plain
    monkeypatch.setattr(cuda_bottleneck, 'fused_identity_bottleneck_plain',
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    block = Bottleneck(spec, 'res5_1', dim_in=c, dim_out=c, stride=1,
                       temp_stride=1, use_temp_conv=use_temp_conv, dilation=d)
    with torch.inference_mode():
        out = block(params_from_jax(jp, 'cpu'), torch.from_numpy(x), False)
    assert len(calls) == 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    # Training, and a spec without the switch, keep the unfused block.
    unfused = Bottleneck(dataclasses.replace(spec, use_pallas_bottleneck=False),
                         'res5_1', dim_in=c, dim_out=c, stride=1,
                         temp_stride=1, use_temp_conv=use_temp_conv,
                         dilation=d)
    with torch.inference_mode():
        out2 = unfused(params_from_jax(jp, 'cpu'), torch.from_numpy(x),
                       False)
        block(params_from_jax(jp, 'cpu'), torch.from_numpy(x), True)
    assert len(calls) == 1
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    assert jax.default_backend() == 'cpu'

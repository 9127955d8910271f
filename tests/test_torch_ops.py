"""The port's ops against lfb_tpu's on the CPU.

Inputs are made from a seed with numpy and fed to both packages in f32.  On
the CPU lfb_tpu takes its plain XLA references (``_attention_xla``,
``roi_align`` + ``max_pool_2d``, ``conv3d``) and the port's kernel wrappers
take their plain PyTorch versions, because the tensors lie on the CPU.

Tolerances: 1e-5 for attention and RoIAlign (f32 sums of at most a few
hundred terms, taken in another order by the two libraries); 1e-4 for the
convolutions (f32 sums of up to 735 products per output).
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from lfb_tpu.models.layers import apply_norm as jax_apply_norm  # noqa: E402
from lfb_tpu.models.layers import layer_norm as jax_layer_norm  # noqa: E402
from lfb_tpu.ops.conv3d import conv1x1 as jax_conv1x1  # noqa: E402
from lfb_tpu.ops.conv3d import conv3d as jax_conv3d  # noqa: E402
from lfb_tpu.ops.attention import _attention_xla  # noqa: E402
from lfb_tpu.ops.pooling import max_pool_2d as jax_max_pool_2d  # noqa: E402
from lfb_tpu.ops.pooling import max_pool_3d as jax_max_pool_3d  # noqa: E402
from lfb_tpu.ops.roi_align import roi_align as jax_roi_align  # noqa: E402
from lfb_tpu.train.checkpoints import tpu_to_c2  # noqa: E402
from lfb_tpu_torch.models.layers import apply_norm, layer_norm  # noqa: E402
from lfb_tpu_torch.ops import cuda_attention, cuda_roi_align  # noqa: E402
from lfb_tpu_torch.ops.attention import scaled_softmax_attention  # noqa: E402
from lfb_tpu_torch.ops.conv3d import conv1x1, conv3d  # noqa: E402
from lfb_tpu_torch.ops.cuda_stem import stem_conv  # noqa: E402
from lfb_tpu_torch.ops.pooling import max_pool_2d, max_pool_3d  # noqa: E402
from lfb_tpu_torch.ops.roi_align import roi_align  # noqa: E402


def rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(port, ref, tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


# --------------------------------------------------------------------------- #
# Attention (kernel 1's module)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize('B,Nq,Nk,C,scale', [
    (4, 1, 300, 64, 64 ** -0.5),     # FBO-NL shape: Nq = 1
    (2, 37, 19, 32, 32 ** -0.5),     # non-aligned Nq and Nk
    (2, 70, 65, 48, None),           # more than one 32-row / 64-key tile
])
def test_softmax_attention_matches_lfb_tpu(B, Nq, Nk, C, scale):
    q, k, v = (rand(B, n, C, seed=s) for s, n in ((0, Nq), (1, Nk), (2, Nk)))
    port = scaled_softmax_attention(t(q), t(k), t(v), scale=scale)
    ref = _attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         scale=scale, mask=None, use_softmax=True)
    close(port, ref, 1e-5)
    # The kernel wrapper's own plain version is what a CPU tensor runs.
    close(cuda_attention.fused_attention(t(q), t(k), t(v), scale=scale),
          ref, 1e-5)


@pytest.mark.parametrize('Nq,Nk,C', [(1, 300, 64), (37, 19, 32)])
def test_softmax_attention_bf16_matches_lfb_tpu(Nq, Nk, C):
    """bf16 on the CPU: both sides round p to bf16 before p.V and the output
    to bf16.  Tolerance one bf16 step per element (2^-7 relative): an f32 sum
    taken in another order may land on the other side of a rounding edge.
    Keeping p in f32 instead moves about a tenth of the elements further."""
    q, k, v = (rand(2, n, C, seed=s) for s, n in ((0, Nq), (1, Nk), (2, Nk)))
    port = scaled_softmax_attention(*(t(a).bfloat16() for a in (q, k, v)),
                                    scale=C ** -0.5)
    ref = _attention_xla(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                         scale=C ** -0.5, mask=None, use_softmax=True)
    assert port.dtype == torch.bfloat16
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2 ** -7, atol=0)


def test_attention_mean_path_matches_lfb_tpu():
    q, k, v = rand(2, 9, 16), rand(2, 12, 16, seed=1), rand(2, 12, 16, seed=2)
    port = scaled_softmax_attention(t(q), t(k), t(v), use_softmax=False)
    ref = _attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         scale=None, mask=None, use_softmax=False)
    close(port, ref, 1e-5)


@pytest.mark.parametrize('mask_rank', [2, 3])
def test_attention_masked_path_matches_lfb_tpu(mask_rank):
    q, k, v = rand(2, 5, 16), rand(2, 11, 16, seed=1), rand(2, 11, 16, seed=2)
    shape = (2, 11) if mask_rank == 2 else (2, 5, 11)
    mask = np.random.RandomState(3).rand(*shape) > 0.3
    mask[..., 0] = True
    port = scaled_softmax_attention(t(q), t(k), t(v), scale=0.25,
                                    mask=t(mask))
    ref = _attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         scale=0.25, mask=jnp.asarray(mask), use_softmax=True)
    close(port, ref, 1e-5)


def test_kernel_wrappers_refuse_non_cuda_devices():
    """Off the CPU a wrapper launches its kernel or raises: a tensor that is
    neither on the CPU nor on a CUDA device never takes the plain path."""
    q = torch.empty((2, 4, 32), device='meta')
    with pytest.raises(ValueError):
        cuda_attention.fused_attention(q, q, q, scale=1.0)
    with pytest.raises(ValueError):
        cuda_roi_align.roi_align_maxpool(
            torch.empty((1, 4, 4, 8), device='meta'),
            torch.empty((2, 5), device='meta'))
    with pytest.raises(ValueError):
        stem_conv(torch.empty((1, 2, 8, 8, 3), device='meta'),
                  torch.empty((64, 3, 1, 7, 7), device='meta'),
                  temporal_pad=0)


# --------------------------------------------------------------------------- #
# RoIAlign + max-pool (kernel 2's module)
# --------------------------------------------------------------------------- #

def _grids(rois, scale=1.0 / 16, pooled=7):
    w = np.maximum((rois[:, 3] - rois[:, 1]) * scale, 1.0)
    h = np.maximum((rois[:, 4] - rois[:, 2]) * scale, 1.0)
    return set(np.clip(np.ceil(w / pooled), 1, 4).astype(int)) | set(
        np.clip(np.ceil(h / pooled), 1, 4).astype(int))


ROIS = {
    14: np.array([[0, 3.0, 5.0, 120.0, 200.0],        # grid 1 x 2
                  [1, 0.0, 0.0, 224.0, 224.0],        # whole 224 crop: grid 2
                  [1, -40.0, 100.0, 250.0, 230.0],    # crosses the border
                  [0, 0.0, 0.0, 0.0, 0.0]],           # all-zero padding box
                 np.float32),
    16: np.array([[0, 0.0, 0.0, 256.0, 256.0],        # whole 256 crop: grid 3
                  [1, 17.3, 40.9, 201.2, 255.9],
                  [0, -80.0, -70.0, 300.0, 290.0],    # border, grid 4
                  [1, 250.0, 250.0, 270.0, 260.0],    # mostly outside
                  [0, 248.0, 248.0, 360.0, 360.0],    # a sample at v == size
                  [1, -24.0, -24.0, 88.0, 88.0],      # a sample at v == -1
                  [0, 0.0, 0.0, 0.0, 0.0]],           # all-zero padding box
                 np.float32),
}


@pytest.mark.parametrize('size', [14, 16])
def test_roi_align_maxpool_matches_lfb_tpu(size):
    fmap = rand(2, size, size, 24, seed=size)
    rois = ROIS[size]
    assert _grids(rois) >= ({1, 2} if size == 14 else {2, 3, 4})
    bins = jax_roi_align(jnp.asarray(fmap), jnp.asarray(rois), pooled_h=7,
                         pooled_w=7, spatial_scale=1 / 16.0, sampling_ratio=0)
    close(roi_align(t(fmap), t(rois)), bins, 1e-5)
    ref = jax_max_pool_2d(bins, (7, 7), (1, 1)).reshape(rois.shape[0], -1)
    close(cuda_roi_align.roi_align_maxpool(t(fmap), t(rois)), ref, 1e-5)


@pytest.mark.parametrize('H,W,C,backward,chunk', [
    (16, 16, 2048, False, 64),      # phase B, crop 256: a 64 KB slice
    (14, 14, 2048, False, 64),      # the train step's forward, crop 224
    (14, 14, 2048, True, 64),       # its backward: one buffer, map then grad
    (20, 27, 2048, False, 16),      # a 320-high crop of a wide frame
    (16, 16, 24, False, 32),        # no chunk twice as wide as C
    (40, 40, 2048, False, 8),       # only 8 channels stay within 64 KB
    (60, 60, 2048, False, 8),       # none does: the smallest that fits
])
def test_roi_channel_chunk_fits_shared_memory(H, W, C, backward, chunk):
    """The channels per CTA of the RoI kernels, chosen from the map's size
    alone (the launch needs no card to plan)."""
    assert cuda_roi_align.channel_chunk(H, W, C, backward) == chunk
    assert cuda_roi_align.smem_bytes(H, W, chunk,
                                     backward) <= cuda_roi_align.SMEM_MAX


@pytest.mark.parametrize('backward', [False, True])
def test_roi_channel_chunk_refuses_a_map_that_does_not_fit(backward):
    with pytest.raises(ValueError):     # 8 channels of 128 x 128: 512 KB
        cuda_roi_align.channel_chunk(128, 128, 2048, backward)


# --------------------------------------------------------------------------- #
# Stem conv (kernel 3's module) and the other convolutions
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize('kt', [5, 1])
def test_stem_conv_matches_lfb_tpu(kt):
    x = rand(2, 4, 20, 18, 3)
    w = rand(kt, 7, 7, 3, 64, seed=1, scale=0.1)
    ref = jax_conv3d(jnp.asarray(x), jnp.asarray(w), strides=(1, 2, 2),
                     padding=(kt // 2, 3, 3))
    port = stem_conv(t(x), t(tpu_to_c2('conv1_w', w)), temporal_pad=kt // 2)
    close(port, ref, 1e-4)


@pytest.mark.parametrize('kt,stride,pad,dil,groups', [
    (3, (1, 1, 1), (1, 0, 0), (1, 1, 1), 1),   # branch2a temporal
    (1, (1, 2, 2), (0, 1, 1), (1, 1, 1), 1),   # branch2b stride 2
    (1, (1, 1, 1), (0, 2, 2), (1, 2, 2), 1),   # res5 dilated
    (1, (1, 1, 1), (0, 1, 1), (1, 1, 1), 2),   # grouped
])
def test_conv3d_matches_lfb_tpu(kt, stride, pad, dil, groups):
    x = rand(2, 4, 9, 9, 8)
    kh = 1 if kt == 3 else 3
    w = rand(kt, kh, kh, 8 // groups, 6, seed=1)
    b = rand(6, seed=2)
    ref = jax_conv3d(jnp.asarray(x), jnp.asarray(w), strides=stride,
                     padding=pad, dilation=dil, groups=groups,
                     bias=jnp.asarray(b))
    port = conv3d(t(x), t(tpu_to_c2('w', w)), strides=stride, padding=pad,
                  dilation=dil, groups=groups, bias=t(b))
    close(port, ref, 1e-4)


def test_conv1x1_matches_lfb_tpu():
    x, w, b = rand(3, 5, 16), rand(1, 1, 1, 16, 8, seed=1), rand(8, seed=2)
    ref = jax_conv1x1(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    close(conv1x1(t(x), t(tpu_to_c2('w', w)), t(b)), ref, 1e-5)


def test_pooling_matches_lfb_tpu():
    x = rand(2, 6, 9, 9, 5)
    close(max_pool_3d(t(x), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
          jax_max_pool_3d(jnp.asarray(x), (1, 3, 3), (1, 2, 2), (0, 1, 1)), 0)
    close(max_pool_3d(t(x), (2, 1, 1), (2, 1, 1)),
          jax_max_pool_3d(jnp.asarray(x), (2, 1, 1), (2, 1, 1)), 0)
    x2 = rand(4, 7, 7, 5)
    close(max_pool_2d(t(x2), (7, 7), (1, 1)),
          jax_max_pool_2d(jnp.asarray(x2), (7, 7), (1, 1)), 0)


@pytest.mark.parametrize('use_affine', [True, False])
def test_apply_norm_inference_matches_lfb_tpu(use_affine):
    x = rand(2, 3, 4, 4, 6)
    names = ('_s', '_b') if use_affine else ('_s', '_b', '_rm', '_riv')
    p = {'n' + s: np.abs(rand(6, seed=i + 1)) for i, s in enumerate(names)}
    ref = jax_apply_norm({k: jnp.asarray(v) for k, v in p.items()}, 'n',
                         jnp.asarray(x), use_affine=use_affine, train=False,
                         epsilon=1e-5, bn_updates=None)
    port = apply_norm({k: t(v) for k, v in p.items()}, 'n', t(x),
                      use_affine=use_affine, epsilon=1e-5)
    close(port, ref, 1e-5)


def test_layer_norm_matches_lfb_tpu():
    x = rand(5, 64, scale=3.0)
    close(layer_norm(t(x)), jax_layer_norm(jnp.asarray(x)), 1e-5)

"""The CUDA kernels, forward and backward, against their plain PyTorch
versions on the card, at edge shapes the flagship does not reach (ragged
query/key tiles, small and non-128 channel counts, crops 224, 256 and 320,
odd sizes, border, shuffled, degenerate and exactly tied boxes), plus the
inputs each wrapper must refuse, and a tiny whole-model forward and train
step on the card against the CPU.  The frozen affine's kernels
(``ops/cuda_affine.py``) are held to their plain versions, PyTorch's own
passes on the card, bit for bit.

These tests need a CUDA device: they carry the ``cuda`` marker and skip
without one.  On a GPU machine, from the root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which the port does not
need.)  TF32 is off, so the plain versions compute in f32.  Bounds, relative
to max |plain|: 1e-5 for f32 outputs, 1e-2 for bf16 outputs (each side
rounds an f32 accumulation to bf16); the backward kernels' outputs are f32
from the same inputs on both sides, 1e-5 (attention in bf16: 1e-2, the
bound of the working type, as ``chip_smoke.py`` holds it; stem dW in f32:
1e-4, sums of up to 125,440 products).  The fused bottleneck: 1e-5 in f32
(three chained sums of at most 6,144 products, in other orders), 1e-2 in
bf16 (both sides round h1, h2 and the output to bf16).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from lfb_tpu_torch.ops import (cuda_attention, cuda_bottleneck,  # noqa: E402
                               cuda_roi_align, cuda_stem)
from lfb_tpu_torch.ops.attention import (  # noqa: E402
    _attention_plain, scaled_softmax_attention)
from lfb_tpu_torch.utils.profiling import counts  # noqa: E402

pytestmark = pytest.mark.cuda


def launches(kernel):
    """The launch counter of ``kernel`` (``attention.fwd``, ...)."""
    return counts().get('kernel.' + kernel, 0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def rand(shape, dev, seed=0, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def assert_close(got, ref, bound, floor=1e-30, name=''):
    """|got - ref| <= bound * max(max |ref|, floor)."""
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all()), name
    err = (got - ref).abs().max().item()
    assert err <= bound * max(ref.abs().max().item(), floor), (name, err)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,Nq,Nk,C', [
    (2, 1, 1, 32), (3, 1, 300, 512), (2, 1, 77, 40),    # Nq = 1 launch
    (2, 37, 19, 32), (2, 70, 130, 64), (1, 100, 65, 512), (2, 33, 1, 96),
])
def test_attention_kernel_matches_plain(dev, dtype, B, Nq, Nk, C):
    q, k, v = (rand((B, n, C), dev, seed, dtype)
               for seed, n in ((0, Nq), (1, Nk), (2, Nk)))
    before = launches('attention.fwd')
    got = cuda_attention.fused_attention(q, k, v, scale=C ** -0.5)
    assert launches('attention.fwd') == before + 1
    bound = 1e-5 if dtype == torch.float32 else 1e-2
    assert_close(got, cuda_attention.attention_plain(q, k, v, C ** -0.5), bound)
    assert_close(got, _attention_plain(q, k, v, scale=C ** -0.5, mask=None,
                                       use_softmax=True), max(bound, 1e-5))


def test_attention_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q = rand((2, 8, 40), dev)
    with pytest.raises(ValueError):                 # C not a multiple of 32
        cuda_attention.fused_attention(q, q, q)
    q = rand((2, 8, 544), dev)
    with pytest.raises(ValueError):                 # C above 512
        cuda_attention.fused_attention(q, q, q)
    q, k = rand((2, 1, 64), dev), rand((2, 60000, 64), dev)
    with pytest.raises(ValueError):                 # Nq = 1, too many keys
        cuda_attention.fused_attention(q, k, k)
    q = rand((2, 8, 64), dev)
    with pytest.raises(ValueError):                 # mixed dtypes
        cuda_attention.fused_attention(q, q.half(), q.half())
    with pytest.raises(ValueError):                 # not contiguous
        cuda_attention.fused_attention(q.transpose(0, 1), q, q)
    with pytest.raises(ValueError):                 # a CPU key
        cuda_attention.fused_attention(q, q.cpu(), q)


ROIS = np.array([[0, 3.0, 5.0, 120.0, 200.0],
                 [1, 0.0, 0.0, 256.0, 256.0],
                 [1, -80.0, -70.0, 300.0, 290.0],
                 [0, 250.0, 250.0, 270.0, 260.0],
                 [1, 17.3, 40.9, 201.2, 255.9],
                 [0, 248.0, 248.0, 360.0, 360.0],   # a sample at v == 16
                 [1, -24.0, -24.0, 88.0, 88.0],     # a sample at v == -1
                 [0, 0.0, 0.0, 0.0, 0.0]], np.float32)


@pytest.mark.parametrize('size,C,pooled', [(14, 24, 7), (16, 2048, 7),
                                           (16, 200, 3), (9, 130, 1)])
def test_roi_kernel_matches_plain(dev, size, C, pooled):
    fmap = rand((2, size, size, C), dev, seed=size)
    rois = torch.from_numpy(ROIS).to(dev)
    before = launches('roi_align.fwd')
    got = cuda_roi_align.roi_align_maxpool(fmap, rois, pooled=pooled)
    assert launches('roi_align.fwd') == before + 1
    assert_close(got, cuda_roi_align.roi_align_maxpool_plain(
        fmap, rois, pooled=pooled), 1e-5)


def test_roi_wrapper_refuses_what_the_kernel_does_not_take(dev):
    fmap, rois = rand((2, 8, 8, 16), dev), torch.from_numpy(ROIS).to(dev)
    with pytest.raises(ValueError):                 # bf16 features
        cuda_roi_align.roi_align_maxpool(fmap.bfloat16(), rois)
    with pytest.raises(ValueError):                 # rois (N, 4)
        cuda_roi_align.roi_align_maxpool(fmap, rois[:, :4].contiguous())
    with pytest.raises(ValueError):                 # pooled above 16
        cuda_roi_align.roi_align_maxpool(fmap, rois, pooled=17)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,kt', [
    ((2, 4, 20, 18, 3), 5), ((1, 3, 21, 19, 3), 1),
    ((1, 2, 224, 224, 3), 5), ((1, 2, 320, 320, 3), 5),
    ((2, 8, 256, 256, 3), 5), ((2, 8, 256, 256, 3), 3),   # crop 256
    ((1, 2, 512, 512, 3), 5),      # Wo = 256, the envelope's edge
    ((1, 2, 510, 510, 3), 5),      # Wo = 255: blocks of one output row
    ((3, 7, 200, 136, 3), 5)])     # 567 blocks: not a multiple of the SMs
def test_stem_kernel_matches_plain(dev, dtype, shape, kt):
    x = rand(shape, dev, dtype=dtype)
    w = rand((64, 3, kt, 7, 7), dev, seed=1) * (2 / (kt * 147)) ** 0.5
    before = launches('stem.fwd')
    got = cuda_stem.stem_conv(x, w, temporal_pad=kt // 2)
    assert launches('stem.fwd') == before + 1
    bound = 1e-5 if dtype == torch.float32 else 1e-2
    assert_close(got, cuda_stem.stem_conv_plain(x, w, kt // 2), bound)


def test_stem_kernel_takes_an_unaligned_input(dev):
    """x 2 bytes past a 4-byte boundary: the bf16 kernel reads it by 2-byte
    loads instead of 4-byte copies."""
    shape = (1, 3, 40, 36, 3)
    n = int(np.prod(shape))
    x = rand((n + 1,), dev, dtype=torch.bfloat16)[1:].view(shape)
    w = rand((64, 3, 5, 7, 7), dev, seed=1) * (2 / 735) ** 0.5
    assert_close(cuda_stem.stem_conv(x, w, temporal_pad=2),
                 cuda_stem.stem_conv_plain(x, w, 2), 1e-2)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_stem_kernel_is_deterministic(dev, dtype):
    """Each output is one CTA's sum in a fixed order: two launches on the
    same input give the same bits."""
    x = rand((2, 8, 224, 224, 3), dev, dtype=dtype)
    w = rand((64, 3, 5, 7, 7), dev, seed=1) * (2 / 735) ** 0.5
    first = cuda_stem.stem_conv(x, w, temporal_pad=2)
    assert torch.equal(first, cuda_stem.stem_conv(x, w, temporal_pad=2))


def test_stem_wrapper_refuses_what_the_kernel_does_not_take(dev):
    w = rand((64, 3, 5, 7, 7), dev)
    with pytest.raises(ValueError):                 # output wider than 256
        cuda_stem.stem_conv(rand((1, 1, 8, 520, 3), dev), w, temporal_pad=2)
    with pytest.raises(ValueError):                 # temporal pad != kT // 2
        cuda_stem.stem_conv(rand((1, 4, 8, 8, 3), dev), w, temporal_pad=1)
    with pytest.raises(ValueError):                 # 4 input channels
        cuda_stem.stem_conv(rand((1, 4, 8, 8, 4), dev), w, temporal_pad=2)
    with pytest.raises(ValueError):                 # bf16 with kT above 5
        cuda_stem.stem_conv(rand((1, 4, 8, 8, 3), dev, dtype=torch.bfloat16),
                            rand((64, 3, 7, 7, 7), dev), temporal_pad=3)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,Nq,Nk,C', [
    (2, 1, 1, 32), (3, 1, 300, 512), (2, 1, 77, 40),    # Nq = 1 launch
    (2, 37, 19, 32), (2, 70, 130, 96), (1, 100, 65, 512), (2, 33, 1, 96),
])
def test_attention_bwd_kernel_matches_plain(dev, dtype, B, Nq, Nk, C):
    q, k, v, do = (rand((B, n, C), dev, seed, dtype)
                   for seed, n in ((0, Nq), (1, Nk), (2, Nk), (3, Nq)))
    scale = C ** -0.5
    out, lse = cuda_attention.fused_attention_lse(q, k, v, scale=scale)
    ref_lse = torch.logsumexp(q.float() @ k.float().transpose(1, 2) * scale,
                              dim=-1)
    assert_close(lse, ref_lse, 1e-5)
    delta = (do.float() * out.float()).sum(-1)
    before = launches('attention.bwd')
    got = cuda_attention.fused_attention_bwd(q, k, v, do, lse, delta,
                                             scale=scale)
    assert launches('attention.bwd') == before + 1
    ref = cuda_attention.attention_bwd_plain(q, k, v, do, lse, delta, scale)
    # With one key dq and dk are zero up to rounding: hold them to the scale
    # of the O(1) inputs.
    for name, a, b in zip(('dq', 'dk', 'dv'), got, ref):
        assert a.dtype == torch.float32
        assert_close(a, b, 1e-5 if dtype == torch.float32 else 1e-2,
                     floor=1.0, name=name)


def test_attention_bwd_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q = rand((2, 8, 64), dev)
    lse = delta = torch.zeros((2, 8), device=dev)
    ok = (q, q, q, q, lse, delta)
    cuda_attention.fused_attention_bwd(*ok, scale=1.0)
    for i, bad in ((3, q.bfloat16()),                     # dO in another type
                   (4, lse[:, :4].contiguous()),          # lse (B, Nq')
                   (5, delta.double()),                   # delta not f32
                   (4, lse.cpu())):                       # lse on the CPU
        args = list(ok)
        args[i] = bad
        with pytest.raises(ValueError):
            cuda_attention.fused_attention_bwd(*args, scale=1.0)
    q1, k1 = rand((2, 1, 64), dev), rand((2, 30000, 64), dev)
    with pytest.raises(ValueError):                 # Nq = 1, too many keys
        cuda_attention.fused_attention_bwd(
            q1, k1, k1, q1, lse[:, :1].contiguous(),
            delta[:, :1].contiguous(), scale=1.0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_attention_on_an_empty_batch_launches_nothing(dev, dtype):
    """The FBO of a batch with no real box row attends B = 0 queries: the
    kernel route gives empty outputs and gradients, and launches nothing
    (a grid of 0 CTAs is refused)."""
    q, k, v = (torch.zeros((0, n, 512), device=dev, dtype=dtype,
                           requires_grad=True) for n in (1, 300, 300))
    before = (launches('attention.fwd'), launches('attention.bwd'))
    out = scaled_softmax_attention(q, k, v, scale=512 ** -0.5)
    out.float().sum().backward()
    assert out.shape == (0, 1, 512) and out.is_cuda and out.dtype == dtype
    for t in (q, k, v):
        assert t.grad.shape == t.shape and t.grad.dtype == dtype
    assert (launches('attention.fwd'), launches('attention.bwd')) == before


@pytest.mark.parametrize('Nq,Nk,C', [(4096, 1024, 256), (4096, 1024, 512),
                                     (3136, 784, 256), (3136, 784, 512)])
def test_attention_kernels_at_the_model_regimes(dev, Nq, Nk, C):
    """The non-local blocks' own bf16 shapes (res3 and res4, crops 256 and
    224) at B = 1, forward and backward, on the tensor-core kernels."""
    q, k, v, do = (rand((1, n, C), dev, seed, torch.bfloat16)
                   for seed, n in ((0, Nq), (1, Nk), (2, Nk), (3, Nq)))
    scale = C ** -0.5
    out, lse = cuda_attention.fused_attention_lse(q, k, v, scale=scale)
    assert_close(out, cuda_attention.attention_plain(q, k, v, scale), 1e-2)
    delta = (do.float() * out.float()).sum(-1)
    got = cuda_attention.fused_attention_bwd(q, k, v, do, lse, delta,
                                             scale=scale)
    ref = cuda_attention.attention_bwd_plain(q, k, v, do, lse, delta, scale)
    for name, a, b in zip(('dq', 'dk', 'dv'), got, ref):
        assert_close(a, b, 1e-2, name=name)


@pytest.mark.parametrize('B,Nq,Nk,C', [(2, 37, 19, 32), (1, 100, 65, 512),
                                       (1, 3136, 784, 512)])
def test_attention_lse_matches_logsumexp(dev, B, Nq, Nk, C):
    """The bf16 tensor-core forward's row log-sum-exp (written by the first
    of the column-split CTAs at C = 512) against torch.logsumexp."""
    q, k, v = (rand((B, n, C), dev, seed, torch.bfloat16)
               for seed, n in ((0, Nq), (1, Nk), (2, Nk)))
    scale = C ** -0.5
    _, lse = cuda_attention.fused_attention_lse(q, k, v, scale=scale)
    ref = torch.logsumexp(q.float() @ k.float().transpose(1, 2) * scale, -1)
    assert_close(lse, ref, 1e-5)


# The bf16 kernels' tiles: query rows in 128-row (C <= 256, forward) and
# 64-row tiles, keys in 64-, 32- and 16-key tiles; these shapes leave a
# ragged tile at each, and C 32 and 96 leave channel panels part-empty.
@pytest.mark.parametrize('C', [32, 64, 96, 256, 512])
@pytest.mark.parametrize('Nq,Nk', [(3136, 784), (100, 65), (37, 19), (37, 1)])
def test_attention_kernels_on_ragged_tiles(dev, Nq, Nk, C):
    q, k, v, do = (rand((1, n, C), dev, seed, torch.bfloat16)
                   for seed, n in ((0, Nq), (1, Nk), (2, Nk), (3, Nq)))
    scale = C ** -0.5
    out, lse = cuda_attention.fused_attention_lse(q, k, v, scale=scale)
    assert_close(out, cuda_attention.attention_plain(q, k, v, scale), 1e-2)
    assert_close(lse, torch.logsumexp(
        q.float() @ k.float().transpose(1, 2) * scale, -1), 1e-5)
    delta = (do.float() * out.float()).sum(-1)
    got = cuda_attention.fused_attention_bwd(q, k, v, do, lse, delta,
                                             scale=scale)
    ref = cuda_attention.attention_bwd_plain(q, k, v, do, lse, delta, scale)
    # With one key dq and dk are zero up to rounding (as above).
    for name, a, b in zip(('dq', 'dk', 'dv'), got, ref):
        assert_close(a, b, 1e-2, floor=1.0 if Nk == 1 else 1e-30, name=name)


@pytest.mark.parametrize('B,Nq,Nk,C', [(2, 100, 65, 256), (1, 100, 65, 512),
                                       (1, 3136, 784, 256),
                                       (1, 3136, 784, 512)])
def test_attention_kernels_are_deterministic(dev, B, Nq, Nk, C):
    """No atomics and a fixed order of sums: two calls of the bf16 forward
    (out, lse) and backward (dq, dk, dv) on the same inputs are bitwise
    equal."""
    q, k, v, do = (rand((B, n, C), dev, seed, torch.bfloat16)
                   for seed, n in ((0, Nq), (1, Nk), (2, Nk), (3, Nq)))
    first = cuda_attention.fused_attention_lse(q, k, v, scale=C ** -0.5)
    second = cuda_attention.fused_attention_lse(q, k, v, scale=C ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    out, lse = first
    delta = (do.float() * out.float()).sum(-1)
    grads = [cuda_attention.fused_attention_bwd(q, k, v, do, lse, delta,
                                                scale=C ** -0.5)
             for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize('which', ['q', 'k', 'v', 'do'])
def test_attention_wrappers_refuse_what_tma_cannot_take(dev, which):
    """bf16 inputs of the tensor-core kernels go through TMA tensor maps,
    which take a 16-byte aligned start and rows a multiple of 16 bytes."""
    B, N, C = 2, 8, 64

    def tensor(name, seed):
        if name != which:
            return rand((B, N, C), dev, seed, torch.bfloat16)
        base = rand((B * N * C + 8,), dev, seed, torch.bfloat16)
        return base[1:1 + B * N * C].view(B, N, C)   # 2 bytes past

    q, k, v, do = (tensor(name, i) for i, name in enumerate(('q', 'k', 'v',
                                                              'do')))
    lse = delta = torch.zeros((B, N), device=dev)
    if which != 'do':
        with pytest.raises(ValueError):
            cuda_attention.fused_attention(q, k, v)
    with pytest.raises(ValueError):
        cuda_attention.fused_attention_bwd(q, k, v, do, lse, delta, scale=1.0)
    q = rand((B, N, 36), dev, dtype=torch.bfloat16)   # rows of 72 bytes
    with pytest.raises(ValueError):
        cuda_attention.fused_attention(q, q, q)


def test_attention_wrapper_refuses_unaligned_bf16(dev):
    base = rand((2 * 8 * 64 + 8,), dev, dtype=torch.bfloat16)
    q = base[1:1 + 2 * 8 * 64].view(2, 8, 64)       # 2 bytes past a boundary
    k = rand((2, 8, 64), dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        cuda_attention.fused_attention(q, k, k)


# Shuffled batch order, borders, a degenerate box.
BWD_ROIS = np.array([[1, 17.3, 40.9, 201.2, 255.9],
                     [0, -80.0, -70.0, 300.0, 290.0],
                     [2, 248.0, 248.0, 360.0, 360.0],
                     [0, 0.0, 0.0, 0.0, 0.0],
                     [1, 0.0, 0.0, 256.0, 256.0],
                     [0, 3.0, 5.0, 120.0, 200.0],
                     [2, -24.0, -24.0, 88.0, 88.0]], np.float32)


@pytest.mark.parametrize('size,C,pooled,tie', [
    (14, 24, 7, False), (16, 2048, 7, False), (14, 256, 7, True),
    (16, 200, 3, False), (9, 130, 1, False)])
def test_roi_bwd_kernel_matches_plain(dev, size, C, pooled, tie):
    """``tie``: every other channel is zero everywhere, so all bins tie
    exactly and the first bin takes the gradient."""
    fmap = rand((3, size, size, C), dev, seed=size)
    if tie:
        fmap[..., ::2] = 0.0
    rois = torch.from_numpy(BWD_ROIS).to(dev)
    dout = rand((rois.shape[0], C), dev, seed=1)
    before = launches('roi_align.bwd')
    got = cuda_roi_align.roi_align_maxpool_bwd(fmap, rois, dout,
                                               pooled=pooled)
    assert launches('roi_align.bwd') == before + 1
    assert_close(got, cuda_roi_align.roi_align_maxpool_bwd_plain(
        fmap, rois, dout, pooled), 1e-5)


def crop_rois(rng, batch_idx, height, width):
    """Boxes in input pixels over a height x width crop, some past its
    border, for the batch elements ``batch_idx``, in that order."""
    n = len(batch_idx)
    x = np.sort(rng.uniform(-0.1 * width, 1.1 * width, (n, 2)), axis=1)
    y = np.sort(rng.uniform(-0.1 * height, 1.1 * height, (n, 2)), axis=1)
    return torch.from_numpy(np.stack(
        [np.asarray(batch_idx, np.float32), x[:, 0], y[:, 0], x[:, 1],
         y[:, 1]], axis=1).astype(np.float32))


def test_roi_bwd_writes_zeros_where_no_box_reaches(dev):
    """The gradient map is not zero-filled before the kernel: batch element
    1, which no box reaches, must come out exactly 0 from its own CTAs even
    where the allocator hands back memory full of NaN."""
    fmap = torch.relu(rand((3, 16, 16, 256), dev))
    rois = crop_rois(np.random.default_rng(0), [0, 2, 2, 0], 256, 256).to(dev)
    dout = rand((4, 256), dev, seed=1)
    junk = torch.full_like(fmap, float('nan'))
    del junk
    got = cuda_roi_align.roi_align_maxpool_bwd(fmap, rois, dout)
    torch.cuda.synchronize()
    assert bool((got[1] == 0).all())
    assert_close(got, cuda_roi_align.roi_align_maxpool_bwd_plain(
        fmap, rois, dout), 1e-5)


@pytest.mark.parametrize('shape', [(2, 20, 27, 2048), (3, 14, 14, 2048)])
def test_roi_kernels_at_larger_and_train_maps(dev, shape):
    """A 20 x 27 map (a 320-high crop of a wide frame, above the flagship's
    16 x 16) and the train step's 14 x 14, forward and backward."""
    B_, H, W, C = shape
    fmap = torch.relu(rand(shape, dev, seed=H))
    rois = crop_rois(np.random.default_rng(H),
                     np.repeat(np.arange(B_), 4), 16 * H, 16 * W).to(dev)
    dout = rand((rois.shape[0], C), dev, seed=2)
    assert_close(cuda_roi_align.roi_align_maxpool(fmap, rois),
                 cuda_roi_align.roi_align_maxpool_plain(fmap, rois), 1e-5)
    assert_close(cuda_roi_align.roi_align_maxpool_bwd(fmap, rois, dout),
                 cuda_roi_align.roi_align_maxpool_bwd_plain(fmap, rois, dout),
                 1e-5)


def test_roi_kernels_take_many_boxes_in_any_order(dev):
    """40 boxes on batch element 1 among 270 of elements 0 and 2, shuffled:
    310 rois, more than one scan of the kernels' 256 threads."""
    rng = np.random.default_rng(3)
    idx = np.concatenate([np.full(40, 1), rng.integers(0, 2, 270) * 2])
    rois = crop_rois(rng, rng.permutation(idx), 256, 256).to(dev)
    fmap = torch.relu(rand((3, 16, 16, 512), dev, seed=4))
    dout = rand((rois.shape[0], 512), dev, seed=5)
    assert_close(cuda_roi_align.roi_align_maxpool(fmap, rois),
                 cuda_roi_align.roi_align_maxpool_plain(fmap, rois), 1e-5)
    assert_close(cuda_roi_align.roi_align_maxpool_bwd(fmap, rois, dout),
                 cuda_roi_align.roi_align_maxpool_bwd_plain(fmap, rois, dout),
                 1e-5)


def test_roi_kernels_take_an_unaligned_map(dev):
    """C a multiple of 4 but the map off a 16-byte boundary: the kernels
    stage it with 4-byte loads."""
    flat = rand((2 * 14 * 14 * 64 + 1,), dev, seed=6)
    fmap = flat[1:].view(2, 14, 14, 64)
    assert fmap.data_ptr() % 16 != 0
    rois = torch.from_numpy(ROIS).to(dev)
    dout = rand((rois.shape[0], 64), dev, seed=7)
    assert_close(cuda_roi_align.roi_align_maxpool(fmap, rois),
                 cuda_roi_align.roi_align_maxpool_plain(fmap, rois), 1e-5)
    assert_close(cuda_roi_align.roi_align_maxpool_bwd(fmap, rois, dout),
                 cuda_roi_align.roi_align_maxpool_bwd_plain(fmap, rois, dout),
                 1e-5)


def test_roi_bwd_kernel_is_deterministic(dev):
    fmap = torch.relu(rand((3, 16, 16, 2048), dev, seed=8))
    rois = torch.from_numpy(BWD_ROIS).to(dev)
    dout = rand((rois.shape[0], 2048), dev, seed=9)
    first = cuda_roi_align.roi_align_maxpool_bwd(fmap, rois, dout)
    second = cuda_roi_align.roi_align_maxpool_bwd(fmap, rois, dout)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_roi_wrappers_refuse_a_map_whose_slice_does_not_fit(dev):
    rois = torch.from_numpy(ROIS).to(dev)
    fmap = rand((2, 128, 128, 8), dev)              # 8 channels: 512 KB
    with pytest.raises(ValueError):
        cuda_roi_align.roi_align_maxpool(fmap, rois)
    with pytest.raises(ValueError):
        cuda_roi_align.roi_align_maxpool_bwd(fmap, rois,
                                             rand((rois.shape[0], 8), dev))


def test_roi_bwd_wrapper_refuses_what_the_kernel_does_not_take(dev):
    fmap, rois = rand((2, 8, 8, 16), dev), torch.from_numpy(ROIS).to(dev)
    dout = rand((rois.shape[0], 16), dev)
    with pytest.raises(ValueError):                 # dout (N, C + 1)
        cuda_roi_align.roi_align_maxpool_bwd(fmap, rois,
                                             rand((rois.shape[0], 17), dev))
    with pytest.raises(ValueError):                 # bf16 dout
        cuda_roi_align.roi_align_maxpool_bwd(fmap, rois, dout.bfloat16())
    with pytest.raises(ValueError):                 # rois on the CPU
        cuda_roi_align.roi_align_maxpool_bwd(fmap, rois.cpu(), dout)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,T,crop,kt', [
    (1, 3, 224, 5), (1, 3, 256, 3), (1, 3, 320, 1), (1, 3, 224, 1),
    (1, 3, 21, 3),
    (2, 5, 224, 5),          # 10 frames: the reduction across frames, clips
    (3, 4, 64, 5)])
def test_stem_dw_kernel_matches_plain(dev, dtype, B, T, crop, kt):
    x = rand((B, T, crop, crop + 2, 3), dev, dtype=dtype)
    ho, wo = (crop - 1) // 2 + 1, (crop + 1) // 2 + 1
    g = rand((B, T, ho, wo, 64), dev, seed=1, dtype=dtype)
    before = launches('stem.dw')
    got = cuda_stem.stem_conv_dw(x, g, kt)
    assert launches('stem.dw') == before + 1
    assert got.shape == (64, 3, kt, 7, 7) and got.dtype == torch.float32
    assert_close(got, cuda_stem.stem_conv_dw_plain(x, g, kt),
                 1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_stem_dw_kernel_is_deterministic(dev, dtype):
    """No float atomics: the same input gives the same bits."""
    x = rand((2, 4, 224, 224, 3), dev, dtype=dtype)
    g = rand((2, 4, 112, 112, 64), dev, seed=1, dtype=dtype)
    first = cuda_stem.stem_conv_dw(x, g, 5)
    assert torch.equal(first, cuda_stem.stem_conv_dw(x, g, 5))


@pytest.mark.parametrize('B,T,crop,kt', [
    (7, 3, 40, 3),           # 21 frames: shares of unequal length
    (1, 1, 16, 5),           # one frame: most taps' roles have none
    (3, 5, 30, 5),           # ragged last band of 256 pixels
    (1, 200, 16, 5)])        # more frames than CTAs
def test_stem_dw_kernel_splits_frames_unevenly(dev, B, T, crop, kt):
    """The bf16 kernel's persistent CTAs each take one temporal tap and a
    share of its frames' bands, which need not divide evenly."""
    x = rand((B, T, crop, crop + 2, 3), dev, dtype=torch.bfloat16)
    ho, wo = (crop - 1) // 2 + 1, (crop + 1) // 2 + 1
    g = rand((B, T, ho, wo, 64), dev, seed=1, dtype=torch.bfloat16)
    got = cuda_stem.stem_conv_dw(x, g, kt)
    assert_close(got, cuda_stem.stem_conv_dw_plain(x, g, kt), 1e-2)
    assert torch.equal(got, cuda_stem.stem_conv_dw(x, g, kt))


def test_stem_dw_wrapper_refuses_an_unaligned_bf16_gradient(dev):
    """g is read by TMA, which takes 16-byte aligned addresses only."""
    x = rand((1, 2, 16, 16, 3), dev, dtype=torch.bfloat16)
    n = 2 * 8 * 8 * 64
    g = rand((n + 1,), dev, dtype=torch.bfloat16)[1:].view(1, 2, 8, 8, 64)
    with pytest.raises(ValueError, match='16-byte'):
        cuda_stem.stem_conv_dw(x, g, 5)
    cuda_stem.stem_conv_dw(x, g.contiguous().clone(), 5)


def test_stem_dw_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x = rand((1, 2, 16, 16, 3), dev)
    g = rand((1, 2, 8, 8, 64), dev)
    cuda_stem.stem_conv_dw(x, g, 5)
    with pytest.raises(ValueError):                 # g of another size
        cuda_stem.stem_conv_dw(x, rand((1, 2, 8, 9, 64), dev), 5)
    with pytest.raises(ValueError):                 # g in another type
        cuda_stem.stem_conv_dw(x, g.bfloat16(), 5)
    with pytest.raises(ValueError):                 # output wider than 256
        cuda_stem.stem_conv_dw(rand((1, 1, 8, 520, 3), dev),
                               rand((1, 1, 4, 260, 64), dev), 1)
    with pytest.raises(ValueError):                 # more than 65535 frames
        cuda_stem.stem_conv_dw(rand((256, 257, 2, 2, 3), dev),
                               rand((256, 257, 1, 1, 64), dev), 1)


def test_tiny_train_step_on_the_card_matches_the_cpu(dev):
    """One f32 train step (dropout 0, explicit bank windows) from the same
    params on the card (kernels) and the CPU (plain versions): loss within
    1e-5; each momentum buffer within 1e-3 of its largest value for the FBO,
    classifier and res5 params and 2e-2 upstream, as in ``chip_smoke.py``
    (sums through 50 layers in other orders flip near-zero ReLU gates, which
    moves the small gradients upstream of them)."""
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.model import init_params
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.train import optimizer
    from lfb_tpu_torch.train.steps import make_train_step, split_params
    cfg = flagship_cfg({'MODEL.DEPTH': 50, 'MODEL.VIDEO_ARC_CHOICE': 2,
                        'TRAIN.VIDEO_LENGTH': 8, 'TRAIN.CROP_SIZE': 64,
                        'LFB.WINDOW_SIZE': 4, 'TPU.COMPUTE_DTYPE': 'float32',
                        'TRAIN.DROPOUT_RATE': 0.0, 'FBO_NL.DROPOUT_RATE': 0.0,
                        'NUM_GPUS': 1})
    spec = build_spec(cfg, 'train')
    params = init_params(spec, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    for name, value in params.items():
        if not value.any():
            params[name] = 0.05 * torch.randn(value.shape, generator=g)
    batch = {'data': torch.randint(0, 256, (2, 8, 64, 64, 3), generator=g,
                                   dtype=torch.uint8),
             'proposals': torch.tensor([[1, 2.0, 3.0, 50.0, 60.0],
                                        [0, 10.0, 0.0, 63.0, 40.0],
                                        [0, 0.0, 0.0, 0.0, 0.0]]),
             'lfb': torch.randn((3, spec.fbo.num_lfb_feat, 2048), generator=g),
             'labels': (torch.rand((3, 80), generator=g) < 0.1).float(),
             'box_mask': torch.tensor([1.0, 1.0, 0.0])}
    results = []
    for device in ('cpu', dev):
        p = {k: v.clone().to(device) for k, v in params.items()}
        trainable, frozen = split_params(spec, p)
        state = optimizer.init_state(p, set(frozen))
        _, _, state, aux = make_train_step(spec, cfg.SOLVER)(
            trainable, frozen, state,
            {k: v.to(device) for k, v in batch.items()},
            torch.Generator(device=device).manual_seed(0), 0.01)
        results.append((aux['loss'].cpu(),
                        {k: v.cpu() for k, v in state.momentum.items()}))
    (cpu_loss, cpu_m), (gpu_loss, gpu_m) = results
    assert abs(gpu_loss.item() - cpu_loss.item()) <= 1e-5 * abs(cpu_loss.item())
    for name, ref in cpu_m.items():
        downstream = (name.startswith(('pred_', 'lfb_', 'res5_'))
                      or '_fbonl_reduc' in name)
        assert_close(gpu_m[name], ref, 1e-3 if downstream else 2e-2,
                     name=name)


def test_tiny_flagship_forward_on_the_card_matches_the_cpu(dev):
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.model import forward, init_params
    from lfb_tpu_torch.models.spec import build_spec
    cfg = flagship_cfg({'TRAIN.VIDEO_LENGTH': 16, 'TEST.VIDEO_LENGTH': 16,
                        'TEST.CROP_SIZE': 64, 'LFB.WINDOW_SIZE': 4,
                        'TPU.COMPUTE_DTYPE': 'float32', 'NUM_GPUS': 1})
    spec = build_spec(cfg, 'test')
    params = init_params(spec, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    for name, value in params.items():
        if not value.any():
            params[name] = 0.05 * torch.randn(value.shape, generator=g)
    batch = {'data': torch.randint(0, 256, (2, 16, 64, 64, 3), generator=g,
                                   dtype=torch.uint8),
             'proposals': torch.tensor([[0, 2.0, 3.0, 50.0, 60.0],
                                        [1, 10.0, 0.0, 63.0, 40.0]]),
             'lfb': torch.randn((2, spec.fbo.num_lfb_feat, 2048), generator=g)}
    cpu = forward(spec, params, batch)
    gpu = forward(spec, {k: v.to(dev) for k, v in params.items()},
                  {k: v.to(dev) for k, v in batch.items()})
    for key in ('box_pooled', 'logits', 'prob'):
        assert_close(gpu[key].cpu(), cpu[key], 1e-4)


def test_fbo_on_the_real_rows_on_the_card_matches_the_cpu(dev):
    """The flagship's FBO at the AVA cells' shapes (16 clips x 32 box rows,
    4 real a clip, 300 window rows, 3 layers, latent 512, f32) on the real
    rows alone, behind a small backbone with no non-local block: the eval
    step's logits and one train step's loss and FBO and classifier
    momentum on the card against the CPU (dropout 0: the two devices' draws
    differ), within the bounds of the tiny steps above.  Each step makes
    the FBO's 3 attention launches forward, and 3 backward in training."""
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.model import init_params
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.train import optimizer
    from lfb_tpu_torch.train.steps import (make_eval_step, make_train_step,
                                           split_params)
    clips, slots, boxes, crop = 16, 32, 4, 64
    cfg = flagship_cfg({'MODEL.DEPTH': 50, 'MODEL.VIDEO_ARC_CHOICE': 2,
                        'RESNETS.WIDTH_PER_GROUP': 8,
                        'NONLOCAL.CONV3_NONLOCAL': False,
                        'NONLOCAL.CONV4_NONLOCAL': False,
                        'TRAIN.VIDEO_LENGTH': 4, 'TEST.VIDEO_LENGTH': 4,
                        'TRAIN.CROP_SIZE': crop, 'TEST.CROP_SIZE': crop,
                        'TRAIN.BATCH_SIZE': clips, 'TEST.BATCH_SIZE': clips,
                        'TPU.COMPUTE_DTYPE': 'float32',
                        'TRAIN.DROPOUT_RATE': 0.0, 'FBO_NL.DROPOUT_RATE': 0.0,
                        'NUM_GPUS': 1})
    spec = build_spec(cfg, 'train')
    n, window = clips * slots, spec.fbo.num_lfb_feat
    assert (slots, window, spec.fbo.num_layers, spec.fbo.latent_dim) == (
        cfg.TPU.MAX_BOXES_PER_CLIP, 300, 3, 512)
    g = torch.Generator().manual_seed(1)
    params = init_params(spec, torch.Generator().manual_seed(0))
    for name, value in params.items():
        if not value.any():
            params[name] = 0.05 * torch.randn(value.shape, generator=g)
    real = (torch.arange(clips)[:, None] * slots
            + torch.arange(boxes)).reshape(-1)
    proposals = torch.zeros((n, 5))
    proposals[real, 0] = (real // slots).float()
    proposals[real, 1:3] = torch.rand((real.numel(), 2), generator=g) * 30
    proposals[real, 3:] = 34 + torch.rand((real.numel(), 2), generator=g) * 30
    lfb = torch.zeros((n, window, 2048))
    lfb[real] = torch.randn((real.numel(), window, 2048), generator=g)
    mask = torch.zeros(n)
    mask[real] = 1.0
    batch = {'data': torch.randint(0, 256, (clips, 4, crop, crop, 3),
                                   generator=g, dtype=torch.uint8),
             'proposals': proposals, 'lfb': lfb, 'box_mask': mask,
             'labels': (torch.rand((n, 80), generator=g) < 0.1).float()
             * mask[:, None]}
    results = []
    for device in ('cpu', dev):
        p = {k: v.clone().to(device) for k, v in params.items()}
        b = {k: v.to(device) for k, v in batch.items()}
        before = (launches('attention.fwd'), launches('attention.bwd'))
        out = make_eval_step(build_spec(cfg, 'test'))(p, b)
        trainable, frozen = split_params(spec, p)
        state = optimizer.init_state(p, set(frozen))
        _, _, state, aux = make_train_step(spec, cfg.SOLVER)(
            trainable, frozen, state, b,
            torch.Generator(device=device).manual_seed(0), 0.01)
        if device != 'cpu':
            assert (launches('attention.fwd') - before[0],
                    launches('attention.bwd') - before[1]) == (6, 3)
        results.append((out['logits'].cpu(), aux['loss'].cpu(),
                        {k: v.cpu() for k, v in state.momentum.items()}))
    (cpu_logits, cpu_loss, cpu_m), (gpu_logits, gpu_loss, gpu_m) = results
    assert_close(gpu_logits[real], cpu_logits[real], 1e-4)
    assert_close(gpu_logits, cpu_logits, 1e-4)
    assert abs(gpu_loss.item() - cpu_loss.item()) <= 1e-5 * abs(cpu_loss.item())
    for name, ref in cpu_m.items():
        if name.startswith(('pred_', 'lfb_')) or '_fbonl_reduc' in name:
            assert_close(gpu_m[name], ref, 1e-3, name=name)


def bottleneck_params(c, ci, kt, dev, seed=0, b2a_shift=0.0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    return (randn(ci, c, kt, 1, 1) * (kt * c) ** -0.5,
            0.1 * randn(ci) + b2a_shift,
            randn(ci, ci, 1, 3, 3) * (9 * ci) ** -0.5, 0.1 * randn(ci),
            randn(c, ci, 1, 1, 1) * 0.2 * ci ** -0.5, 0.1 * randn(c))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
# The kernel cuts H into bands of about 16384 / (Ci * W) rows (at least 4):
# one band for the small shapes, several (the last one shorter) where Ci * W
# is large.
@pytest.mark.parametrize('shape,ci,kt,d,b2a_shift', [
    ((2, 4, 8, 8, 128), 32, 3, 1, 0.0),
    ((2, 4, 8, 8, 128), 32, 1, 2, 3.0),        # relu(b2a) >> 0 at borders
    ((1, 3, 13, 11, 64), 16, 3, 2, 3.0),       # odd H and W
    ((1, 3, 13, 16, 64), 256, 3, 2, 3.0),      # bands of 4, 4, 4, 1 rows
    ((1, 5, 11, 8, 64), 512, 3, 1, 0.0),       # bands of 4, 4, 3, odd T
    ((2, 2, 5, 19, 32), 256, 1, 2, 3.0),       # bands of 3 and 2, d = 2
    ((1, 4, 56, 56, 256), 64, 3, 1, 0.0),      # crop 224: res2
    ((1, 4, 28, 28, 512), 128, 1, 1, 0.0),     # res3
    ((1, 4, 14, 14, 1024), 256, 3, 1, 0.0),    # res4
    ((1, 2, 14, 14, 2048), 512, 3, 2, 0.0),    # res5, dilated
    ((1, 4, 80, 80, 256), 64, 3, 1, 0.0),      # crop 320: res2
    ((1, 4, 40, 40, 512), 128, 3, 1, 0.0),     # res3
    ((1, 4, 20, 20, 1024), 256, 1, 1, 0.0),    # res4
    ((1, 2, 20, 20, 2048), 512, 1, 1, 0.0),    # res5, undilated
    ((1, 2, 16, 16, 2048), 512, 3, 2, 0.0),    # crop 256: res5, dilated
    ((2, 3, 10, 21, 512), 128, 1, 1, 3.0),     # W not a multiple of 8
])
def test_fused_bottleneck_matches_plain(dev, dtype, shape, ci, kt, d,
                                        b2a_shift):
    x = torch.relu(rand(shape, dev, seed=5)).to(dtype)
    p = bottleneck_params(shape[-1], ci, kt, dev, b2a_shift=b2a_shift)
    before = launches('bottleneck.fwd')
    got = cuda_bottleneck.fused_identity_bottleneck(
        x, *p, temporal_pad=kt // 2, dilation=d)
    assert launches('bottleneck.fwd') == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    ref = cuda_bottleneck.fused_identity_bottleneck_plain(
        x, *p, temporal_pad=kt // 2, dilation=d)
    assert_close(got, ref, 1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize('shape,ci,kt,d,b2a_shift', [
    ((1, 3, 9, 13, 64), 16, 3, 1, 3.0),        # 117 pixels; C 64, Ci 16
    ((2, 2, 11, 15, 64), 16, 1, 2, 3.0),       # ragged residues of d = 2
    ((1, 3, 12, 11, 256), 64, 3, 1, 0.0),      # 132 pixels a frame
    ((2, 1, 7, 9, 2048), 512, 3, 2, 3.0),      # C 2048, Ci 512 at d = 2
    ((1, 2, 10, 10, 2048), 512, 1, 2, 0.0),    # 25-pixel residues
    ((2, 1, 8, 8, 128), 32, 3, 1, 0.0),        # T 1, kT 3
    ((1, 1, 6, 6, 512), 128, 3, 1, 3.0),       # T 1, the whole frame a band
    ((1, 3, 5, 7, 96), 48, 3, 3, 1.0),         # C, Ci not multiples of 64
    ((1, 2, 6, 6, 64), 320, 1, 1, 0.0),        # Ci past 256, not 512
])
def test_fused_bottleneck_bf16_on_ragged_tiles(dev, shape, ci, kt, d,
                                                b2a_shift):
    """Shapes ragged against the bf16 kernel's tiles: passes of 64 or 128
    pixels, 64-channel chunks, 16 KB weight slots and residues of d."""
    x = torch.relu(rand(shape, dev, seed=5)).to(torch.bfloat16)
    p = bottleneck_params(shape[-1], ci, kt, dev, b2a_shift=b2a_shift)
    got = cuda_bottleneck.fused_identity_bottleneck(
        x, *p, temporal_pad=kt // 2, dilation=d)
    ref = cuda_bottleneck.fused_identity_bottleneck_plain(
        x, *p, temporal_pad=kt // 2, dilation=d)
    assert_close(got, ref, 1e-2)


@pytest.mark.parametrize('shape,ci,kt,d', [
    ((2, 4, 16, 16, 1024), 256, 3, 1), ((1, 2, 16, 16, 2048), 512, 3, 2),
    ((1, 4, 24, 24, 256), 64, 3, 1)])
def test_fused_bottleneck_bf16_is_deterministic(dev, shape, ci, kt, d):
    """No float atomics, a fixed order: two calls give the same bits."""
    x = torch.relu(rand(shape, dev, seed=5)).to(torch.bfloat16)
    p = bottleneck_params(shape[-1], ci, kt, dev)
    first = cuda_bottleneck.fused_identity_bottleneck(
        x, *p, temporal_pad=kt // 2, dilation=d)
    assert torch.equal(first, cuda_bottleneck.fused_identity_bottleneck(
        x, *p, temporal_pad=kt // 2, dilation=d))


def test_fused_bottleneck_wrapper_refuses_an_unaligned_bf16_input(dev):
    """x is read by TMA and 16-byte copies: 16-byte aligned addresses only."""
    shape = (1, 2, 8, 8, 64)
    n = 2 * 8 * 8 * 64
    x = torch.relu(rand((n + 1,), dev)).to(torch.bfloat16)[1:].view(shape)
    p = bottleneck_params(64, 16, 3, dev)
    with pytest.raises(ValueError, match='16-byte'):
        cuda_bottleneck.fused_identity_bottleneck(x, *p, temporal_pad=1)
    cuda_bottleneck.fused_identity_bottleneck(x.clone(), *p, temporal_pad=1)


def test_fused_bottleneck_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x = rand((1, 2, 8, 8, 64), dev)
    p = bottleneck_params(64, 16, 3, dev)
    cuda_bottleneck.fused_identity_bottleneck(x, *p, temporal_pad=1)
    with pytest.raises(ValueError):                 # temporal_pad != kT // 2
        cuda_bottleneck.fused_identity_bottleneck(x, *p, temporal_pad=0)
    with pytest.raises(ValueError):                 # C not a multiple of 16
        cuda_bottleneck.fused_identity_bottleneck(
            rand((1, 2, 8, 8, 40), dev), *bottleneck_params(40, 16, 3, dev),
            temporal_pad=1)
    with pytest.raises(ValueError):                 # weights on the CPU
        cuda_bottleneck.fused_identity_bottleneck(
            x, *(t.cpu() for t in p), temporal_pad=1)
    with pytest.raises(ValueError):                 # not an identity block
        cuda_bottleneck.fused_identity_bottleneck(
            rand((1, 2, 8, 8, 128), dev), *p, temporal_pad=1)
    with pytest.raises(ValueError):                 # float16
        cuda_bottleneck.fused_identity_bottleneck(x.half(), *p, temporal_pad=1)


def test_tiny_charades_forward_on_the_card_matches_the_cpu(dev):
    """Charades (clip head, post-act FBO-NL) with the fused bottleneck: the
    12 identity blocks of R50 launch the kernel on the card."""
    from lfb_tpu_torch.config import charades_cfg
    from lfb_tpu_torch.models.model import forward, init_params
    from lfb_tpu_torch.models.spec import build_spec
    cfg = charades_cfg({'MODEL.DEPTH': 50, 'MODEL.VIDEO_ARC_CHOICE': 2,
                        'TRAIN.VIDEO_LENGTH': 8, 'TEST.VIDEO_LENGTH': 8,
                        'TEST.CROP_SIZE': 64, 'LFB.WINDOW_SIZE': 4,
                        'TPU.COMPUTE_DTYPE': 'float32',
                        'TPU.PALLAS_BOTTLENECK': True, 'NUM_GPUS': 1})
    spec = build_spec(cfg, 'test')
    params = init_params(spec, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    for name, value in params.items():
        if not value.any():
            params[name] = 0.05 * torch.randn(value.shape, generator=g)
    batch = {'data': torch.randint(0, 256, (2, 8, 64, 64, 3), generator=g,
                                   dtype=torch.uint8),
             'lfb': torch.randn((2, 4, 2048), generator=g)}
    cpu = forward(spec, params, batch)
    before = launches('bottleneck.fwd')
    gpu = forward(spec, {k: v.to(dev) for k, v in params.items()},
                  {k: v.to(dev) for k, v in batch.items()})
    assert launches('bottleneck.fwd') == before + 12
    for key in ('pool5', 'logits', 'prob'):
        assert_close(gpu[key].cpu(), cpu[key], 1e-4)


# --------------------------------------------------------------------------- #
# The frozen affine with its shortcut and ReLU: bit for bit
# --------------------------------------------------------------------------- #

AFFINE_SHORTCUTS = ('none', 'identity', 'affine')


def with_specials(shape, dev, seed, dtype):
    """3 N(0, 1) with NaN, +-inf, +-0, tiny values and bf16's largest
    scattered in, in ``dtype``."""
    x = rand(shape, dev, seed) * 3
    flat = x.view(-1)
    values = torch.tensor([float('nan'), float('inf'), -float('inf'), 0.0,
                           -0.0, 1e-30, -1e-30, 65504.0], device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    picks = torch.randperm(flat.numel(), generator=g, device=dev)
    flat[picks[:len(values)]] = values[:flat.numel()]
    return x.to(dtype)


def same_bits(got, want, name=''):
    torch.cuda.synchronize()
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert torch.equal(got.view(view[got.dtype]),
                       want.view(view[want.dtype])), name


def affine_operands(shape, shortcut, dtype, dev):
    c = shape[-1]
    x = with_specials(shape, dev, 0, dtype)
    s, b, rs, rb = (rand((c,), dev, seed) for seed in (1, 2, 4, 5))
    s[0] = -0.0
    r = None if shortcut == 'none' else with_specials(shape, dev, 3, dtype)
    if shortcut != 'affine':
        rs = rb = None
    return x, s, b, r, rs, rb


# C 64 and 2048 (the model's), 13 and 1 (not a multiple of 8: the scalar
# kernel), rows not a multiple of a CTA's, and 2 x 8 x 64 x 64 x 256, which
# takes several turns of the grid-stride loop.
AFFINE_SHAPES = [(2, 3, 5, 7, 64), (3, 1, 2, 5, 2048), (5, 11, 13), (9, 1),
                 (1000, 24), (2, 8, 64, 64, 256)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('relu', [True, False])
@pytest.mark.parametrize('shortcut', AFFINE_SHORTCUTS)
@pytest.mark.parametrize('shape', AFFINE_SHAPES)
def test_affine_kernels_match_plain_bitwise(dev, shape, shortcut, relu,
                                            dtype):
    from lfb_tpu_torch.ops import cuda_affine as ca
    x, s, b, r, rs, rb = affine_operands(shape, shortcut, dtype, dev)
    before = launches('affine.fwd'), launches('affine.bwd')
    y = ca.affine_act_fwd(x, s, b, relu, r, rs, rb)
    same_bits(y, ca.affine_act_plain(x, s, b, relu, r, rs, rb), 'y')
    dy = with_specials(shape, dev, 6, dtype)
    dy.view(-1)[::7] = 0.0
    saved = y if relu else None
    got = ca.affine_act_bwd(dy, saved, s, rs)
    want = ca.affine_act_bwd_plain(dy, saved, s, rs)
    for name, a, w in zip(('dx', 'g', 'dr'), got, want, strict=True):
        assert (a is None) == (w is None), name
        if a is not None:
            same_bits(a, w, name)
    assert (launches('affine.fwd'), launches('affine.bwd')) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shortcut', AFFINE_SHORTCUTS)
def test_affine_op_gradients_match_the_composition_bitwise(dev, shortcut,
                                                           dtype):
    """Through autograd: the op's gradients of x and the residual against
    the composition's (``affine_nd``, ``+``, ``F.relu``) on the card."""
    from lfb_tpu_torch.ops import cuda_affine as ca
    x, s, b, r, rs, rb = affine_operands((4, 6, 6, 64), shortcut, dtype, dev)
    dy = with_specials((4, 6, 6, 64), dev, 6, dtype)
    grads = []
    for fn in (ca.affine_act_plain, lambda *a: ca.affine_act(
            a[0], a[1], a[2], relu=a[3], residual=a[4], residual_scale=a[5],
            residual_bias=a[6])):
        leaves = [t.clone().requires_grad_(True)
                  for t in ([x] if r is None else [x, r])]
        y = fn(leaves[0], s, b, True, leaves[1] if r is not None else None,
               rs, rb)
        grads.append(torch.autograd.grad(y, leaves, dy))
    for want, got in zip(*grads, strict=True):
        same_bits(got, want)


def test_affine_kernels_take_an_unaligned_input(dev):
    """x and the residual 2 bytes off 16: the scalar kernels, same bits."""
    from lfb_tpu_torch.ops import cuda_affine as ca
    shape = (3, 5, 64)
    n = math.prod(shape)
    x, r = (with_specials((n + 1,), dev, seed, torch.bfloat16)[1:].view(shape)
            for seed in (0, 3))
    assert x.data_ptr() % 16 and x.is_contiguous()
    s, b = rand((64,), dev, 1), rand((64,), dev, 2)
    y = ca.affine_act_fwd(x, s, b, True, r)
    same_bits(y, ca.affine_act_plain(x, s, b, True, r))
    for a, w in zip(ca.affine_act_bwd(r, y, s), ca.affine_act_bwd_plain(r, y, s)):
        if w is not None:
            same_bits(a, w)


def test_affine_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from lfb_tpu_torch.ops import cuda_affine as ca
    x = rand((4, 64), dev).to(torch.bfloat16)
    s, b = rand((64,), dev, 1), rand((64,), dev, 2)
    for args in [(x.half(), s, b, True),                         # float16
                 (x, s.double(), b, True),                       # f64 scale
                 (x, s[:32], b, True),                           # short scale
                 (x, s.cpu(), b, True),                          # on the CPU
                 (x.t(), rand((4,), dev), rand((4,), dev), True),  # strided
                 (x, s, b, True, x[:2]),                         # residual
                 (x, s, b, True, x.float()),
                 (x, s, b, True, x, s, None)]:                   # no bias
        with pytest.raises(ValueError):
            ca.affine_act_fwd(*args)


@pytest.mark.parametrize('fused', [False, True])
def test_r101_forward_launches_the_affine_kernel_once_a_site(dev, fused):
    """An R101 backbone forward (bf16) launches the kernel once per frozen
    affine but the stem's: three a bottleneck block (none in a fused
    identity block) and one a non-local block.  The stem's affine and ReLU
    run in the pool kernel's fused pass, one of its 7 launches (the stem,
    pool2 and 5 non-local pools), none of which writes offsets."""
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.backbone import Backbone
    from lfb_tpu_torch.models.model import init_params
    from lfb_tpu_torch.models.spec import build_spec
    cfg = flagship_cfg({'TEST.VIDEO_LENGTH': 8, 'TEST.CROP_SIZE': 64,
                        'LFB.WINDOW_SIZE': 4, 'NUM_GPUS': 1,
                        'TPU.PALLAS_BOTTLENECK': fused})
    spec = build_spec(cfg, 'test')
    assert sum(spec.block_counts) == 33
    assert spec.use_pallas_bottleneck == fused
    params = init_params(spec, torch.Generator(device=dev).manual_seed(0))
    x = rand((2, 8, 64, 64, 3), dev).to(torch.bfloat16)
    names = ('affine.fwd', 'pool.fwd', 'pool.fwd_saved')
    before = [launches(n) for n in names]
    with torch.no_grad():
        Backbone(spec)(params, x)
    blocks = 4 if fused else sum(spec.block_counts)
    non_local = sum(len(idx) for idx in spec.nl_blocks.values())
    assert non_local == 5
    assert [launches(n) - b for n, b in zip(names, before)] == [
        3 * blocks + non_local, 2 + non_local, 0]


# --------------------------------------------------------------------------- #
# The channels-last max pool: ATen's forward bit for bit, a deterministic
# gather-form backward
# --------------------------------------------------------------------------- #

POOL_WINDOWS = {'pool1': ((1, 3, 3), (1, 2, 2), (0, 1, 1)),
                'pool2': ((2, 1, 1), (2, 1, 1), (0, 0, 0)),
                'non_local': ((1, 2, 2), (1, 2, 2), (0, 0, 0))}
# Odd T, H and W (the padded edges, floor mode's dropped last row); C 64
# (16-byte columns), 13 (one channel a thread) and 1024 (a row's items take
# several turns of the CTA).
POOL_SHAPES = [(2, 5, 7, 9, 64), (1, 4, 6, 5, 13), (1, 2, 8, 8, 1024)]


def pool_input(shape, dev, seed, dtype):
    """ReLU'd N(0, 1) (ties at 0), a few equal positive values, NaN and
    -inf, written in ``dtype``."""
    x = torch.relu(rand(shape, dev, seed))
    flat = x.view(-1)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    picks = torch.randperm(flat.numel(), generator=g, device=dev)
    flat[picks[:flat.numel() // 8]] = 1.5
    x = x.to(dtype)
    flat = x.view(-1)
    flat[picks[-6:-3]] = float('nan')
    flat[picks[-3:]] = -float('inf')
    return x


def aten_pool(x, window, indices=False):
    out = torch.nn.functional.max_pool3d(x.permute(0, 4, 1, 2, 3), *window,
                                         return_indices=indices)
    if indices:
        return out[0].permute(0, 2, 3, 4, 1), out[1].permute(0, 2, 3, 4, 1)
    return out.permute(0, 2, 3, 4, 1)


def pool_flat_index(offsets, in_shape, window):
    """ATen's flat (t, h, w) index of each window offset."""
    (kt, kh, kw), strides, pads = window
    _, T, H, W, _ = in_shape
    o = offsets.long()
    start = [torch.arange(n, device=offsets.device) * s - p
             for n, s, p in zip(offsets.shape[1:4], strides, pads)]
    t = start[0][:, None, None, None] + o // (kh * kw)
    h = start[1][None, :, None, None] + (o // kw) % kh
    w = start[2][None, None, :, None] + o % kw
    return (t * H + h) * W + w


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', POOL_SHAPES)
@pytest.mark.parametrize('name', POOL_WINDOWS)
def test_pool_kernel_is_aten_bit_for_bit(dev, name, shape, dtype):
    """The values and the chosen positions (the offsets against ATen's int64
    index and the plain version's offsets), ties, NaN and -inf included."""
    from lfb_tpu_torch.ops import cuda_pool as cp
    window = POOL_WINDOWS[name]
    x = pool_input(shape, dev, 0, dtype)
    before = launches('pool.fwd'), launches('pool.fwd_saved')
    y, offsets = cp.max_pool_fwd(x, *window, save=True)
    y2, none = cp.max_pool_fwd(x, *window, save=False)
    assert none is None
    assert (launches('pool.fwd'), launches('pool.fwd_saved')) == (
        before[0] + 2, before[1] + 1)
    want, index = aten_pool(x, window, indices=True)
    same_bits(y, want.contiguous(), 'y')
    same_bits(y2, y, 'y without offsets')
    plain_y, plain_offsets = cp.max_pool_plain(x, *window)
    same_bits(plain_y, y, 'plain y')
    assert torch.equal(offsets, plain_offsets)
    assert torch.equal(pool_flat_index(offsets, shape, window), index)


def test_pool_kernel_takes_an_unaligned_input(dev):
    """x 2 bytes off 16: one channel a thread, the same bits."""
    from lfb_tpu_torch.ops import cuda_pool as cp
    shape = (1, 3, 7, 7, 64)
    n = math.prod(shape)
    x = pool_input((n + 1,), dev, 1, torch.bfloat16)[1:].view(shape)
    assert x.data_ptr() % 16 and x.is_contiguous()
    for window in POOL_WINDOWS.values():
        y, offsets = cp.max_pool_fwd(x, *window, save=True)
        same_bits(y, aten_pool(x, window).contiguous())
        dy = rand(y.shape, dev, 2).to(torch.bfloat16)
        same_bits(cp.max_pool_bwd(dy, offsets, shape, *window),
                  cp.max_pool_bwd_plain(dy, offsets, shape, *window))


def stem_pool_operands(shape, dev, dtype, seed=3):
    c = shape[-1]
    x = with_specials(shape, dev, seed, dtype)
    s, b = rand((c,), dev, seed + 1), rand((c,), dev, seed + 2)
    s[0] = -0.0
    return x, s, b


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(2, 3, 9, 11, 64), (1, 2, 7, 6, 13)])
def test_stem_pool_kernel_is_the_composition_bit_for_bit(dev, shape, dtype):
    """max_pool3d(affine_act(x)) in one pass: forward bit for bit (NaN,
    infinities and signed zeros in x, a -0 scale), offsets as the plain
    version's; the backward bit for bit as the plain version's, which is
    the composition's pool, threshold and multiply backward."""
    from lfb_tpu_torch.ops import cuda_affine as ca
    from lfb_tpu_torch.ops import cuda_pool as cp
    window = POOL_WINDOWS['pool1']
    x, s, b = stem_pool_operands(shape, dev, dtype)
    before = launches('affine.fwd')
    y, offsets = cp.max_pool_fwd(x, *window, save=True, scale=s, bias=b)
    assert launches('affine.fwd') == before
    composed = ca.affine_act_fwd(x, s, b, True)
    same_bits(y, aten_pool(composed, window).contiguous(), 'y')
    plain_y, plain_offsets = cp.max_pool_plain(composed, *window)
    assert torch.equal(offsets, plain_offsets)
    dy = with_specials(y.shape, dev, 7, dtype)
    dy.view(-1)[::5] = 0.0
    before = launches('pool.bwd')
    dx = cp.max_pool_bwd(dy, offsets, shape, *window, y=y, scale=s)
    assert launches('pool.bwd') == before + 1
    same_bits(dx, cp.max_pool_bwd_plain(dy, offsets, shape, *window, y=y,
                                        scale=s), 'dx')


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', POOL_SHAPES)
@pytest.mark.parametrize('name', POOL_WINDOWS)
def test_pool_bwd_kernel_matches_plain_and_aten(dev, name, shape, dtype):
    """dx bit for bit as the plain gather (f32 sums in output order, one
    rounding), the same bits on a second run, and ATen's autograd: bit for
    bit where one window claims a position, else within 2 eps of the sum of
    the terms' magnitudes (ATen rounds each of up to three partial sums, in
    the order its atomics land)."""
    from lfb_tpu_torch.ops import cuda_pool as cp
    window = POOL_WINDOWS[name]
    x = torch.relu(rand(shape, dev, 4)).to(dtype)
    _, offsets = cp.max_pool_fwd(x, *window, save=True)
    dy = rand(offsets.shape, dev, 5).to(dtype)
    dx = cp.max_pool_bwd(dy, offsets, shape, *window)
    same_bits(dx, cp.max_pool_bwd_plain(dy, offsets, shape, *window), 'dx')
    same_bits(cp.max_pool_bwd(dy, offsets, shape, *window), dx, 'rerun')
    leaf = x.clone().requires_grad_(True)
    want, = torch.autograd.grad(aten_pool(leaf, window), leaf, dy)
    terms = cp.max_pool_bwd_plain(dy.abs().float(), offsets, shape, *window)
    ones = cp.max_pool_bwd_plain(torch.ones_like(dy, dtype=torch.float32),
                                 offsets, shape, *window)
    single = ones <= 1
    same_bits(dx[single], want[single], 'single claims')
    err = (dx.float() - want.float()).abs()
    assert bool((err <= 2 * torch.finfo(dtype).eps * terms).all())


def test_pool_bwd_kernel_is_deterministic_where_windows_overlap(dev):
    """pool1 at the train crop's shape with many tied maxima (a quarter of
    the input equal), so most positions take several windows: ten runs,
    one set of bits."""
    from lfb_tpu_torch.ops import cuda_pool as cp
    window = POOL_WINDOWS['pool1']
    shape = (2, 4, 112, 112, 64)
    x = torch.relu(rand(shape, dev, 6)).to(torch.bfloat16)
    x.view(-1)[::4] = 3.0
    y, offsets = cp.max_pool_fwd(x, *window, save=True)
    dy = rand(y.shape, dev, 7).to(torch.bfloat16)
    first = cp.max_pool_bwd(dy, offsets, shape, *window)
    for _ in range(9):
        same_bits(cp.max_pool_bwd(dy, offsets, shape, *window), first)


def test_pool_op_saves_offsets_only_for_a_backward(dev):
    """No offsets (and no int64 index) without a gradient: the op runs the
    kernel alone; with one it keeps uint8 offsets for its backward."""
    from lfb_tpu_torch.ops import cuda_pool as cp
    window = POOL_WINDOWS['non_local']
    x = rand((2, 4, 8, 8, 64), dev, 8).to(torch.bfloat16)
    before = launches('pool.fwd'), launches('pool.fwd_saved')
    with torch.no_grad():
        assert cp.max_pool(x.requires_grad_(True), *window).grad_fn is None
    y = cp.max_pool(x, *window)
    assert type(y.grad_fn).__name__ == 'MaxPoolBackward'
    assert (launches('pool.fwd'), launches('pool.fwd_saved')) == (
        before[0] + 2, before[1] + 1)
    offsets = y.grad_fn.saved_tensors[0]
    assert offsets.dtype == torch.uint8 and offsets.shape == y.shape


def test_stem_and_pool1_gradient_matches_the_unfused_composition(dev):
    """One f32 step of the stem conv, its affine, ReLU and pool1: the fused
    pass's loss and gradients (conv1_w, the input clip) against the stem,
    ``affine_act`` and ATen's pool (sums of up to 4 windows in f32, in
    another order: 1e-5)."""
    from lfb_tpu_torch.models.layers import norm_act
    from lfb_tpu_torch.ops import cuda_affine as ca
    from lfb_tpu_torch.ops.cuda_stem import StemConv
    x = rand((2, 4, 64, 64, 3), dev, 9)
    w = rand((64, 3, 3, 7, 7), dev, 10) * 0.05
    s, b = rand((64,), dev, 11), rand((64,), dev, 12)
    params = {'res_conv1_bn_s': s, 'res_conv1_bn_b': b}
    window = POOL_WINDOWS['pool1']

    def fused(xl, wl):
        h = StemConv.apply(xl, wl, 1)
        return norm_act(params, 'res_conv1_bn', h, use_affine=True,
                        epsilon=1e-5, relu=True, pool=window)

    def composition(xl, wl):
        h = StemConv.apply(xl, wl, 1)
        return aten_pool(ca.affine_act(h, s, b, relu=True), window)

    dy = rand((2, 4, 16, 16, 64), dev, 13)
    results = []
    for fn in (fused, composition):
        xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(xl, wl)
        results.append((y, *torch.autograd.grad(y, (xl, wl), dy)))
    for name, got, want in zip(('y', 'dx', 'dw'), *results):
        if name == 'y':
            same_bits(got.contiguous(), want.contiguous(), name)
        else:
            assert_close(got, want, 1e-5, name=name)


def test_non_local_block_gradient_matches_the_unfused_composition(
        dev, monkeypatch):
    """One f32 step of a res3 non-local block (its 1x2x2 pool on the kernel)
    against the same block on ATen's pool: windows that do not overlap, so
    the output and every gradient bit for bit."""
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.backbone import NonLocal
    from lfb_tpu_torch.models.model import init_params
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.ops import cuda_pool as cp
    cfg = flagship_cfg({'TRAIN.VIDEO_LENGTH': 8, 'TRAIN.CROP_SIZE': 64,
                        'LFB.WINDOW_SIZE': 4, 'TPU.COMPUTE_DTYPE': 'float32',
                        'NUM_GPUS': 1})
    spec = build_spec(cfg, 'train')
    params = init_params(spec, torch.Generator(device=dev).manual_seed(0))
    prefix = 'nonlocal_conv3_1'
    p = {k: v for k, v in params.items() if k.startswith(prefix)}
    trained = [v.requires_grad_(True) for k, v in p.items()
               if not k.endswith(('_bn_s', '_bn_b'))]     # frozen affine
    block = NonLocal(spec, prefix, grouped=False)
    x = rand((2, 4, 8, 8, 512), dev, 14)
    dy = rand(x.shape, dev, 15)
    results = []
    for pool in ('kernel', 'aten'):
        if pool == 'aten':
            monkeypatch.setattr(cp, 'max_pool',
                                lambda t, *w, **_: aten_pool(t, w))
        before = launches('pool.bwd')
        xl = x.clone().requires_grad_(True)
        y = block(p, xl, True)
        grads = torch.autograd.grad(y, [xl, *trained], dy)
        assert launches('pool.bwd') - before == (pool == 'kernel')
        results.append((y, *grads))
    for got, want in zip(*results):
        same_bits(got.contiguous(), want.contiguous())


def test_pool_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from lfb_tpu_torch.ops import cuda_pool as cp
    x = rand((1, 2, 8, 8, 64), dev).to(torch.bfloat16)
    s, b = rand((64,), dev, 1), rand((64,), dev, 2)
    pool1 = POOL_WINDOWS['pool1']
    for args, kwargs in [((x.half(), *pool1), {}),                 # float16
                         ((x[0], (3, 3), (2, 2), (1, 1)), {}),     # 4-D
                         ((x, (1, 3, 3), (1, 2, 2), (0, 2, 2)), {}),  # pad
                         ((x, (1, 17, 17), (1, 1, 1), (0, 0, 0)), {}),  # 289
                         ((x, (1, 9, 9), (1, 1, 1), (0, 0, 0)), {}),  # no out
                         ((x, *pool1), {'scale': s}),              # no bias
                         ((x, *pool1), {'scale': s[:32], 'bias': b}),
                         ((x, *pool1), {'scale': s.double(), 'bias': b}),
                         ((x, *pool1), {'scale': s.cpu(), 'bias': b})]:
        with pytest.raises(ValueError):
            cp.max_pool_fwd(*args, save=False, **kwargs)

"""The CUDA kernels, forward and backward, against their plain PyTorch
versions on the card, at edge shapes the flagship does not reach (ragged
query/key tiles, small and non-128 channel counts, crops 224, 256 and 320,
odd sizes, border, shuffled, degenerate and exactly tied boxes), plus the
inputs each wrapper must refuse, and a tiny whole-model forward and train
step on the card against the CPU.

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

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from lfb_tpu_torch.ops import (cuda_attention, cuda_bottleneck,  # noqa: E402
                               cuda_roi_align, cuda_stem)
from lfb_tpu_torch.ops.attention import _attention_plain  # noqa: E402
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

"""The CUDA kernels against their plain PyTorch versions on the card, at
edge shapes the flagship does not reach (ragged query/key tiles, small and
non-128 channel counts, crops 224 and 320, odd sizes, border boxes), plus
the inputs each wrapper must refuse, and a tiny whole-model forward on the
card against the CPU.

These tests need a CUDA device: they carry the ``cuda`` marker and skip
without one.  On a GPU machine, from the root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which the port does not
need.)  TF32 is off, so the plain versions compute in f32.  Bounds, relative
to max |plain|: 1e-5 for f32 outputs, 1e-2 for bf16 outputs (each side
rounds an f32 accumulation to bf16).
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from lfb_tpu_torch.ops import cuda_attention, cuda_roi_align, cuda_stem  # noqa: E402
from lfb_tpu_torch.ops.attention import _attention_plain  # noqa: E402

pytestmark = pytest.mark.cuda


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


def assert_close(got, ref, bound):
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    err = (got - ref).abs().max().item()
    assert err <= bound * max(ref.abs().max().item(), 1e-30), err


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,Nq,Nk,C', [
    (2, 1, 1, 32), (3, 1, 300, 512), (2, 1, 77, 40),    # Nq = 1 launch
    (2, 37, 19, 32), (2, 70, 130, 64), (1, 100, 65, 512), (2, 33, 1, 96),
])
def test_attention_kernel_matches_plain(dev, dtype, B, Nq, Nk, C):
    q, k, v = (rand((B, n, C), dev, seed, dtype)
               for seed, n in ((0, Nq), (1, Nk), (2, Nk)))
    before = cuda_attention.LAUNCHES
    got = cuda_attention.fused_attention(q, k, v, scale=C ** -0.5)
    assert cuda_attention.LAUNCHES == before + 1
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
    before = cuda_roi_align.LAUNCHES
    got = cuda_roi_align.roi_align_maxpool(fmap, rois, pooled=pooled)
    assert cuda_roi_align.LAUNCHES == before + 1
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
    ((1, 2, 224, 224, 3), 5), ((1, 2, 320, 320, 3), 5)])
def test_stem_kernel_matches_plain(dev, dtype, shape, kt):
    x = rand(shape, dev, dtype=dtype)
    w = rand((64, 3, kt, 7, 7), dev, seed=1) * (2 / (kt * 147)) ** 0.5
    before = cuda_stem.LAUNCHES
    got = cuda_stem.stem_conv(x, w, temporal_pad=kt // 2)
    assert cuda_stem.LAUNCHES == before + 1
    bound = 1e-5 if dtype == torch.float32 else 1e-2
    assert_close(got, cuda_stem.stem_conv_plain(x, w, kt // 2), bound)


def test_stem_wrapper_refuses_what_the_kernel_does_not_take(dev):
    w = rand((64, 3, 5, 7, 7), dev)
    with pytest.raises(ValueError):                 # output wider than 256
        cuda_stem.stem_conv(rand((1, 1, 8, 520, 3), dev), w, temporal_pad=2)
    with pytest.raises(ValueError):                 # temporal pad != kT // 2
        cuda_stem.stem_conv(rand((1, 4, 8, 8, 3), dev), w, temporal_pad=1)
    with pytest.raises(ValueError):                 # 4 input channels
        cuda_stem.stem_conv(rand((1, 4, 8, 8, 4), dev), w, temporal_pad=2)


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

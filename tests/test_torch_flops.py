"""The port's cost model (``lfb_tpu_torch/utils/flops.py``) on the CPU,
against ``lfb_tpu.utils.flops`` where the two count the same thing.

* ``count_params`` equals ``lfb_tpu``'s on params carried across by
  ``params_from_jax``.
* ``cost_analysis`` of a tiny flagship forward against XLA's count of the
  same forward, same spec and inputs.  The two count convolutions
  differently: ``FlopCounterMode`` counts every tap of the kernel (what a
  conv implementation computes, the zero padding included), XLA's analysis
  only the taps that land inside the input.  At crop 32 the res4 / res5
  maps are 2 x 2, so the padding taps are a fifth of the port's count.
  Less those taps (computed here from each recorded conv's shapes), the
  port's count is 2.2-2.5% below XLA's, which also counts elementwise work
  (the affines, ReLUs, softmax); the bound is 5%.
* The full-width flagship forward of ``tools.mfu_probe``'s grid (B 8, crop
  224, train mode with the loss) counts 4.288 TF: convolutions 3.6266,
  matmuls 0.3793, attention 0.2820 (q k^T and p v once each); 0.188 TF of
  it are padding taps.
* A dilated conv counts what the undilated conv with the same output
  shape counts; the count does not depend on whether the arguments are
  real CPU tensors, fake or on the meta device; the bytes are each op's
  arguments and results; ``save_graph_text`` writes the aten graph.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

import lfb_tpu.models as jax_models  # noqa: E402
from lfb_tpu.utils import flops as jax_flops  # noqa: E402
from lfb_tpu_torch.config import flagship_cfg  # noqa: E402
from lfb_tpu_torch.convert import params_from_jax  # noqa: E402
from lfb_tpu_torch.models.model import forward, init_params  # noqa: E402
from lfb_tpu_torch.models.spec import build_spec  # noqa: E402
from lfb_tpu_torch.ops.conv3d import conv3d  # noqa: E402
from lfb_tpu_torch.tools import mfu_probe  # noqa: E402
from lfb_tpu_torch.utils import flops  # noqa: E402
from tests.torch_threads import worker_threads  # noqa: E402,F401

T, CROP, CLIPS, BOXES = 8, 32, 2, 2
TINY = {'TRAIN.VIDEO_LENGTH': T, 'TEST.VIDEO_LENGTH': T,
        'TRAIN.CROP_SIZE': CROP, 'TEST.CROP_SIZE': CROP,
        'TRAIN.BATCH_SIZE': CLIPS, 'LFB.WINDOW_SIZE': 4,
        'TPU.COMPUTE_DTYPE': 'float32', 'NUM_GPUS': 1}
XLA_BOUND = 5e-2
# The grid forward at B = 8, crop 224 (mfu_probe.run_grid's first row).
FULL_TF = {'aten.convolution': 3.626621730816, 'aten.mm': 0.37934596096,
           'aten.bmm': 0.282033651712}


@pytest.fixture(scope='module')
def tiny():
    """The tiny flagship: port cfg, lfb_tpu's spec and params (numpy zeros
    of their shapes: counts read no value), the port's params and a
    batch."""
    cfg = flagship_cfg(TINY)
    jspec = jax_models.build_spec(cfg, 'test')
    shapes = jax.eval_shape(lambda key: jax_models.init_params(key, jspec),
                            jax.random.PRNGKey(0))
    params = {k: np.zeros(v.shape, v.dtype) for k, v in shapes.items()}
    rng = np.random.RandomState(0)
    n = CLIPS * BOXES
    batch = {'data': rng.randn(CLIPS, T, CROP, CROP, 3).astype(np.float32),
             'proposals': np.stack(
                 [np.repeat(np.arange(CLIPS), BOXES)]
                 + [rng.uniform(0, CROP, n) for _ in range(4)], 1)
             .astype(np.float32),
             'lfb': rng.randn(n, jspec.fbo.num_lfb_feat, 2048)
             .astype(np.float32)}
    return cfg, jspec, params, params_from_jax(params, device='cpu'), batch


def test_count_params_matches_lfb_tpu(tiny):
    _, _, params, port_params, _ = tiny
    assert flops.count_params(port_params) == jax_flops.count_params(params)
    assert flops.count_params(port_params) > 10 ** 7


def padding_tap_flops(sig):
    """FLOPs of ``sig``'s kernel taps that fall on zero padding: XLA's cost
    analysis leaves them out, ``FlopCounterMode`` counts them."""
    cout, cin_g, *ks = sig.w_shape
    inside = 2.0 * sig.x_shape[0] * cout * cin_g
    for n, k, s, p, d in zip(sig.x_shape[1:4], ks, sig.strides, sig.padding,
                             sig.dilation):
        out = (n + 2 * p - d * (k - 1) - 1) // s + 1
        inside *= sum(0 <= o * s - p + j * d < n
                      for o in range(out) for j in range(k))
    return sig.flops() - inside


def test_tiny_forward_count_matches_xla(tiny):
    cfg, jspec, params, port_params, batch = tiny
    xla = jax_flops.cost_analysis(
        lambda p, b: jax_models.forward(jspec, p, b, train=False)['prob'],
        params, batch)['flops']
    spec = build_spec(cfg, 'test')
    port = flops.cost_analysis(
        lambda p, b: forward(spec, p, b)['prob'], port_params,
        {k: torch.from_numpy(v) for k, v in batch.items()})['flops']
    sigs = mfu_probe.collect_sigs(build_spec(cfg, 'train'), CLIPS, CROP)
    padding = sum(padding_tap_flops(sig) * n for sig, n in sigs.items()
                  if sig.kind in ('conv3d', 'stem'))
    assert 0.15 < padding / port < 0.25
    gap = (xla - (port - padding)) / xla
    assert 0 < gap < XLA_BOUND, (port, padding, xla)


def test_full_width_flagship_count():
    """4.288 TF at B 8, crop 224 on fake tensors: each op counted once."""
    _, spec = mfu_probe._flagship(224, 8)
    mode = torch._subclasses.fake_tensor.FakeTensorMode()
    with mode:
        params = init_params(spec, torch.Generator().manual_seed(0))
        batch = {k: torch.empty(v) for k, v in {
            'data': (8, 32, 224, 224, 3), 'labels': (32, 80),
            'proposals': (32, 5), 'box_mask': (32,),
            'lfb': (32, spec.fbo.num_lfb_feat, 2048)}.items()}
    counter = torch.utils.flop_counter.FlopCounterMode(display=False)
    fake = flops.fake_cpu(mode, (params, batch))
    with mode, counter, torch.no_grad():
        mfu_probe._loss_fn(spec)(*fake)
    by_op = {str(k): v / 1e12
             for k, v in counter.get_flop_counts()['Global'].items()}
    assert by_op == pytest.approx(FULL_TF, rel=1e-9)
    with torch.no_grad():
        total = flops.cost_analysis(mfu_probe._loss_fn(spec), params,
                                    batch)['flops']
    assert total / 1e12 == pytest.approx(4.288, rel=2e-2)
    assert total / 1e12 == pytest.approx(sum(FULL_TF.values()), rel=1e-9)
    # Of it, the backbone's convolution taps on zero padding (which XLA's
    # count leaves out): 0.188 TF.
    sigs = mfu_probe.collect_sigs(spec, 8, 224)
    padding = sum(padding_tap_flops(sig) * n for sig, n in sigs.items()
                  if sig.kind in ('conv3d', 'stem'))
    assert padding / 1e12 == pytest.approx(0.1878, rel=1e-3)


def test_dilated_conv_counts_its_output():
    """A 1x3x3 dilation-2 conv (res5's) counts what the undilated 1x3x3
    conv with the same output shape counts."""
    x = torch.zeros(2, 4, 14, 14, 64)
    w = torch.zeros(64, 64, 1, 3, 3)
    dilated = flops.cost_analysis(
        lambda x, w: conv3d(x, w, padding=(0, 2, 2), dilation=(1, 2, 2)),
        x, w)['flops']
    plain = flops.cost_analysis(
        lambda x, w: conv3d(x, w, padding=(0, 1, 1)), x, w)['flops']
    assert dilated == plain == 2.0 * 2 * 4 * 14 * 14 * 64 * 64 * 9


def test_count_is_the_same_for_real_fake_and_meta_tensors(tiny):
    cfg, _, _, port_params, batch = tiny
    spec = build_spec(cfg, 'test')
    fn = lambda p, b: forward(spec, p, b)['prob']  # noqa: E731
    real_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    real = flops.cost_analysis(fn, port_params, real_batch)
    meta = flops.cost_analysis(
        fn, {k: v.to('meta') for k, v in port_params.items()},
        {k: v.to('meta') for k, v in real_batch.items()})
    mode = torch._subclasses.fake_tensor.FakeTensorMode()
    fake = flops.cost_analysis(fn, *flops.fake_cpu(mode, (port_params,
                                                          real_batch)))
    assert real == meta == fake
    assert real['flops'] > 0 and real['bytes accessed'] > 0


def test_bytes_are_each_ops_arguments_and_results():
    x, y = torch.zeros(64, 32), torch.zeros(32, 16)
    costs = flops.cost_analysis(lambda x, y: (x @ y).relu(), x, y)
    mm = (64 * 32 + 32 * 16 + 64 * 16) * 4
    relu = 2 * 64 * 16 * 4
    assert costs == {'flops': 2.0 * 64 * 32 * 16, 'bytes accessed': mm + relu}
    # A view moves nothing.
    assert flops.cost_analysis(lambda x: x.reshape(2, -1).t()[1:], x)[
        'bytes accessed'] == 0


def test_log_flops_params(tiny, caplog):
    cfg, _, _, port_params, batch = tiny
    spec = build_spec(cfg, 'test')
    with caplog.at_level('INFO', logger=flops.__name__):
        costs = flops.log_flops_params(
            lambda p, b: forward(spec, p, b)['prob'], port_params,
            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert 'Model: {:.2f} GFLOPs, {:.2f}M params'.format(
        costs['flops'] / 1e9, flops.count_params(port_params) / 1e6) in \
        caplog.text


def test_save_graph_text_names_the_convolution(tmp_path):
    x, w = torch.zeros(1, 4, 8, 8, 3), torch.zeros(8, 3, 3, 3, 3)
    path = flops.save_graph_text(
        lambda x, w: conv3d(x, w, padding=(1, 1, 1)).relu(),
        str(tmp_path / 'graph.txt'), x, w)
    text = open(path).read()
    assert 'aten.convolution' in text and 'aten.relu' in text

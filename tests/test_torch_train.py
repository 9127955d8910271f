"""The port's training path against lfb_tpu on the CPU.

Inputs are made from a seed with numpy and fed to both packages.  On the CPU
lfb_tpu takes its XLA references, and the port's kernel wrappers and
autograd Functions take their plain PyTorch versions, because the tensors
lie on the CPU; the interpret-mode cases hold those plain versions against
the Pallas backward kernels themselves.

Tolerances, relative to the largest reference value of each compared
tensor: 1e-5 for f32 attention and RoIAlign gradients (f32 sums of a few
hundred terms in another order); 1e-4 for the stem (sums of up to several
thousand products); 2e-2 for bf16 attention gradients (the port forms the
backward in f32 from bf16 inputs, lfb_tpu's autodiff rounds p and its
cotangents to bf16 on the way: a few bf16 steps of 2^-8).  The whole step:
see :func:`test_two_train_steps_match_lfb_tpu`.
"""

import copy
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lfb_tpu.models as jax_models  # noqa: E402
from lfb_tpu.core.config import load_config  # noqa: E402
from lfb_tpu.models import model as jax_model  # noqa: E402
from lfb_tpu.ops import pallas_attention, pallas_roi_align, pallas_stem  # noqa: E402
from lfb_tpu.ops.attention import scaled_softmax_attention as jax_attention  # noqa: E402
from lfb_tpu.ops.conv3d import conv3d as jax_conv3d  # noqa: E402
from lfb_tpu.ops.pooling import max_pool_2d as jax_max_pool_2d  # noqa: E402
from lfb_tpu.ops.roi_align import roi_align as jax_roi_align  # noqa: E402
from lfb_tpu.train import optimizer as jax_opt  # noqa: E402
from lfb_tpu.train.checkpoints import tpu_to_c2, write_pkl  # noqa: E402
from lfb_tpu.train.lr_policy import get_lr_at_iter  # noqa: E402
from lfb_tpu.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from lfb_tpu.train.steps import split_params as jax_split_params  # noqa: E402
from lfb_tpu_torch.config import charades_cfg, flagship_cfg  # noqa: E402
from lfb_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from lfb_tpu_torch.models import model as port_model  # noqa: E402
from lfb_tpu_torch.models.layers import dropout  # noqa: E402
from lfb_tpu_torch.models.spec import build_spec  # noqa: E402
from lfb_tpu_torch.ops import cuda_attention, cuda_roi_align, cuda_stem  # noqa: E402
from lfb_tpu_torch.ops.attention import scaled_softmax_attention  # noqa: E402
from lfb_tpu_torch.ops.roi_align import roi_align  # noqa: E402
from lfb_tpu_torch.train import checkpoints as port_ckpt  # noqa: E402
from lfb_tpu_torch.train import lr_policy as port_lr  # noqa: E402
from lfb_tpu_torch.train import optimizer as opt  # noqa: E402
from lfb_tpu_torch.train import steps as port_steps  # noqa: E402
from lfb_tpu_torch.train.steps import (make_eval_step,  # noqa: E402
                                       make_train_step, split_params)
from tests import padding_rows  # noqa: E402
from tests.test_torch_model import (PORT_READS, TINY, jax_shapes,  # noqa: E402
                                   perturbed_params)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The flagship arc cut to a step that runs in seconds: R50 I3D, T 8, crop
# 32, a 2 s window, f32, no dropout (the two packages draw other random
# numbers), XLA references on the lfb_tpu side.
STEP_CFG = {'MODEL.DEPTH': 50, 'MODEL.VIDEO_ARC_CHOICE': 2,
            'TRAIN.VIDEO_LENGTH': 8, 'TEST.VIDEO_LENGTH': 8,
            'TRAIN.CROP_SIZE': 32, 'TEST.CROP_SIZE': 32,
            'LFB.WINDOW_SIZE': 2, 'TPU.COMPUTE_DTYPE': 'float32',
            'TRAIN.DROPOUT_RATE': 0.0, 'FBO_NL.DROPOUT_RATE': 0.0,
            'TPU.USE_PALLAS': False, 'NUM_GPUS': 1}


def rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(port, ref, tol, floor=1e-30):
    """|port - ref| <= tol * max(max |ref|, floor)."""
    ref = np.asarray(ref, np.float32)
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port, np.float32)
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), floor))


@pytest.fixture
def interpret(monkeypatch):
    """Run every ``pallas_call`` in interpret mode (as
    ``tests/test_pallas_interpret.py`` does)."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, 'pallas_call',
                        lambda *a, **k: orig(*a, interpret=True, **k))


# --------------------------------------------------------------------------- #
# The flagship config and the train spec
# --------------------------------------------------------------------------- #


def test_flagship_cfg_is_the_released_config():
    released = load_config(os.path.join(REPO, 'configs',
                                        'ava_r101_lfb_nl_3l.yaml'))
    mine = flagship_cfg()
    for section, keys in PORT_READS.items():
        for key in keys:
            assert mine[section][key] == released[section][key], (section, key)
    assert mine.DATASET == released.DATASET
    for it in (0, 1000, 1999, 2000, 99999, 100000, 125000, 139999):
        assert get_lr_at_iter(mine.SOLVER, it) == get_lr_at_iter(
            released.SOLVER, it), it


def test_build_spec_for_training():
    spec = build_spec(flagship_cfg(), 'train')
    assert (spec.crop_size, spec.dropout_rate, spec.video_length) == (
        224, 0.3, 32)
    assert build_spec(flagship_cfg(), 'test').crop_size == 256
    cfg = flagship_cfg(STEP_CFG)
    jspec = jax_models.build_spec(cfg, 'train')
    spec = build_spec(cfg, 'train')
    for field in ('crop_size', 'video_length', 'dropout_rate', 'fbo', 'nl',
                  'head_dim', 'freeze_backbone', 'use_affine'):
        mine, theirs = getattr(spec, field), getattr(jspec, field)
        if dataclasses.is_dataclass(mine):
            mine, theirs = dataclasses.asdict(mine), dataclasses.asdict(theirs)
        assert mine == theirs, field


# --------------------------------------------------------------------------- #
# Optimizer, loss, frozen names, dropout
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize('nesterov', [True, False])
def test_sgd_update_matches_lfb_tpu(nesterov):
    names = {'conv_w': (4, 3, 3, 1, 1), 'x_bn_s': (4,), 'pred_w': (5, 7)}
    params = {k: rand(*s, seed=i) for i, (k, s) in enumerate(names.items())}
    kw = dict(momentum=0.9, nesterov=nesterov, weight_decay=1e-4,
              weight_decay_bn=1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jax_opt.init_state(jp, frozen=set())
    state = opt.init_state({k: t(v) for k, v in params.items()}, set())
    port = {k: t(v).clone() for k, v in params.items()}
    for step, lr in enumerate((0.1, 0.05, 0.05)):
        grads = {k: rand(*s, seed=10 + step) for k, s in names.items()}
        jp, jstate = jax_opt.apply_updates(
            jp, {k: jnp.asarray(v) for k, v in grads.items()}, jstate,
            lr=jnp.float32(lr), **kw)
        port, state = opt.apply_updates(
            port, {k: t(v) for k, v in grads.items()}, state, lr=lr, **kw)
        if step == 0:
            jstate = jax_opt.correct_momentum(jstate, jnp.float32(0.5))
            state = opt.correct_momentum(state, 0.5)
    for k in names:
        np.testing.assert_allclose(port[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(state.momentum[k].numpy(),
                                   np.asarray(jstate.momentum[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize('multi_label,masked', [(True, True), (True, False),
                                                (False, False)])
def test_loss_matches_lfb_tpu(multi_label, masked):
    spec = build_spec(flagship_cfg({**STEP_CFG,
                                    'MODEL.MULTI_LABEL': multi_label}),
                      'train')
    jspec = jax_models.build_spec(flagship_cfg(
        {**STEP_CFG, 'MODEL.MULTI_LABEL': multi_label}), 'train')
    logits = rand(6, 80, scale=3.0)
    labels = ((np.random.RandomState(1).rand(6, 80) < 0.1).astype(np.float32)
              if multi_label else np.arange(6).astype(np.int32) * 7)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32) if masked else None
    num, den = port_steps.loss_parts(spec, t(logits), t(labels),
                                     None if mask is None else t(mask))
    jnum, jden = jax_model.loss_parts(jspec, jnp.asarray(logits),
                                      jnp.asarray(labels),
                                      None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(num.item(), float(jnum), rtol=1e-6)
    assert den.item() == float(jden)
    loss = port_steps.loss(spec, t(logits), t(labels),
                           None if mask is None else t(mask))
    jloss = jax_model._loss(jspec, jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)


@pytest.mark.parametrize('freeze_backbone', [False, True])
def test_frozen_names_match_lfb_tpu(freeze_backbone):
    cfg = flagship_cfg({**TINY, 'MODEL.FREEZE_BACKBONE': freeze_backbone})
    jspec = jax_models.build_spec(cfg, 'train')
    spec = build_spec(cfg, 'train')
    shapes = jax_shapes(jspec)
    params = port_model.init_params(spec, torch.Generator().manual_seed(0))
    assert set(params) == set(shapes)
    frozen = port_model.frozen_param_names(spec, params)
    assert frozen == jax_model.frozen_param_names(jspec, shapes)
    trainable, frozen_params = split_params(spec, params)
    jtrainable, jfrozen = jax_split_params(jspec, shapes)
    assert (set(trainable), set(frozen_params)) == (set(jtrainable),
                                                     set(jfrozen))
    assert ('conv1_w' in trainable) != freeze_backbone
    assert 'pred_w' in trainable and 'res_conv1_bn_s' in frozen_params


def test_dropout_scales_kept_elements_and_repeats_with_the_seed():
    x = torch.ones((200, 500))
    y = dropout(x, 0.3, torch.Generator().manual_seed(5))
    kept = y != 0
    assert abs(1 - kept.float().mean().item() - 0.3) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    again = dropout(x, 0.3, torch.Generator().manual_seed(5))
    assert torch.equal(y, again)
    other = dropout(x, 0.3, torch.Generator().manual_seed(6))
    assert not torch.equal(y, other)
    assert dropout(x, 0.0, torch.Generator()) is x
    assert dropout(x.bfloat16(), 0.3, torch.Generator()).dtype == torch.bfloat16


# --------------------------------------------------------------------------- #
# Gradients of the three kernels' modules (CPU path) against jax.grad
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('B,Nq,Nk,C', [
    (3, 1, 300, 64),     # FBO-NL: Nq = 1
    (2, 1, 1, 32),       # one key
    (2, 37, 19, 32),     # ragged query and key tiles
    (2, 70, 65, 48),     # more than one 32-row / 64-key tile
])
def test_attention_gradients_match_lfb_tpu(dtype, B, Nq, Nk, C):
    q, k, v = (rand(B, n, C, seed=s) for s, n in ((0, Nq), (1, Nk), (2, Nk)))
    w = rand(B, Nq, C, seed=3)
    scale = C ** -0.5
    jdt = jnp.dtype(dtype)

    def jloss(q, k, v):
        out = jax_attention(q, k, v, scale=scale)
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(a, jdt) for a in (q, k, v)))
    tdt = getattr(torch, dtype)
    leaves = [t(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    out = scaled_softmax_attention(*leaves, scale=scale)
    (out.float() * t(w)).sum().backward()
    assert out.dtype == tdt and all(x.grad.dtype == tdt for x in leaves)
    tol = 1e-5 if dtype == 'float32' else 2e-2
    close(out, jout, 1e-5 if dtype == 'float32' else 2 ** -7)
    # With one key dq and dk are zero up to rounding: hold them to the scale
    # of the O(1) inputs.
    for name, leaf, ref in zip('qkv', leaves, jgrads):
        close(leaf.grad, ref, tol, floor=1.0)


def test_attention_lse_and_inference_path():
    """The forward's lse is logsumexp of the scaled logits; without a
    gradient the Function keeps the inference path (no lse)."""
    q, k, v = (t(rand(2, n, 32, seed=s)) for s, n in ((0, 5), (1, 9), (2, 9)))
    out, lse = cuda_attention.fused_attention_lse(q, k, v, scale=0.3)
    torch.testing.assert_close(lse, torch.logsumexp(q @ k.transpose(1, 2) * 0.3,
                                                    dim=-1))
    torch.testing.assert_close(out, cuda_attention.fused_attention(q, k, v,
                                                                   scale=0.3))
    with torch.inference_mode():
        torch.testing.assert_close(scaled_softmax_attention(q, k, v, scale=0.3),
                                   out)


# Out of batch order, a degenerate (all-zero) box, a box crossing the border.
ROIS = np.array([[1, 32.0, 48.0, 120.0, 200.0],
                 [0, 0.0, 0.0, 224.0, 224.0],
                 [2, 5.5, 3.25, 60.75, 90.5],
                 [0, 0.0, 0.0, 0.0, 0.0],
                 [1, -40.0, 100.0, 250.0, 230.0],
                 [0, 10.0, 10.0, 100.0, 180.0]], np.float32)


@pytest.mark.parametrize('tie', [False, True])
def test_roi_gradients_match_lfb_tpu(tie):
    """``tie``: half of the channels are zero everywhere, so all 49 bins of
    every box tie exactly and the first bin must take the gradient."""
    fmap = rand(3, 14, 14, 24, seed=4)
    if tie:
        fmap[..., ::2] = 0.0
    dout = rand(ROIS.shape[0], 24, seed=5)

    def jloss(f):
        bins = jax_roi_align(f, jnp.asarray(ROIS), pooled_h=7, pooled_w=7,
                             spatial_scale=1 / 16.0, sampling_ratio=0)
        out = jax_max_pool_2d(bins, (7, 7), (1, 1)).reshape(ROIS.shape[0], -1)
        return jnp.sum(out * dout), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(fmap))
    f = t(fmap).requires_grad_(True)
    rois = t(ROIS).requires_grad_(True)
    out = cuda_roi_align.RoIAlignMaxPool.apply(f, rois, 7, 1 / 16.0)
    (out * t(dout)).sum().backward()
    close(out, jout, 1e-5)
    close(f.grad, jgrad, 1e-5)
    assert rois.grad is None
    if tie:
        # Each tied (box, channel) sends its whole gradient to bin (0, 0).
        f0 = t(fmap).requires_grad_(True)
        bins = roi_align(f0, t(ROIS))
        g = torch.zeros_like(bins)
        g[:, 0, 0, ::2] = t(dout)[:, ::2]
        ref, = torch.autograd.grad(bins, f0, g)
        close(f.grad[..., ::2], ref[..., ::2], 1e-6)


@pytest.mark.parametrize('kt', [5, 1])
def test_stem_gradients_match_lfb_tpu(kt):
    x = rand(2, 4, 20, 18, 3)
    w = rand(kt, 7, 7, 3, 64, seed=1, scale=0.1)
    g = rand(2, 4, 10, 9, 64, seed=2)

    def jloss(x, w):
        out = jax_conv3d(x, w, strides=(1, 2, 2), padding=(kt // 2, 3, 3))
        return jnp.sum(out * g)

    jdx, jdw = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x),
                                                         jnp.asarray(w))
    xs = t(x).requires_grad_(True)
    ws = t(tpu_to_c2('conv1_w', w)).requires_grad_(True)
    (cuda_stem.StemConv.apply(xs, ws, kt // 2) * t(g)).sum().backward()
    close(ws.grad, tpu_to_c2('conv1_w', np.asarray(jdw)), 1e-4)
    close(xs.grad, jdx, 1e-4)
    # Without an input gradient (training: the input is data) only dW runs.
    ws.grad = None
    (cuda_stem.StemConv.apply(t(x), ws, kt // 2) * t(g)).sum().backward()
    close(ws.grad, tpu_to_c2('conv1_w', np.asarray(jdw)), 1e-4)


# --------------------------------------------------------------------------- #
# The Pallas backward kernels (interpret mode) against the port's plain
# versions of them
# --------------------------------------------------------------------------- #

def test_attention_bwd_plain_matches_the_pallas_kernel(interpret):
    B, Nq, Nk, C = 2, 12, 8, 128
    q, k, v, do = (rand(B, n, C, seed=s)
                   for s, n in ((0, Nq), (1, Nk), (2, Nk), (3, Nq)))
    scale = C ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    out, lse = pallas_attention._fwd_call(jq, jk, jv, scale)
    delta = jnp.sum(jdo * out, axis=-1, keepdims=True)
    ref = pallas_attention._bwd_call(jq, jk, jv, jdo, lse, delta, scale)
    port_out, port_lse = cuda_attention.attention_fwd_lse_plain(
        t(q), t(k), t(v), scale)
    close(port_lse, np.asarray(lse)[..., 0], 1e-6)
    close(port_out, out, 1e-5)
    got = cuda_attention.attention_bwd_plain(
        t(q), t(k), t(v), t(do), t(np.asarray(lse)[..., 0]),
        t(np.asarray(delta)[..., 0]), scale)
    for name, a, b in zip(('dq', 'dk', 'dv'), got, ref):
        close(a, b, 1e-5)


def test_roi_bwd_plain_matches_the_pallas_kernel(interpret):
    fmap = rand(3, 14, 14, 128, seed=6)
    fmap[..., :64] = 0.0                      # exact ties in half the channels
    rois = ROIS[[0, 3, 2, 1]]
    dout = rand(rois.shape[0], 128, seed=7)
    ref = pallas_roi_align._bwd_call(jnp.asarray(fmap), jnp.asarray(rois),
                                     jnp.asarray(dout), 7, 1 / 16.0)
    got = cuda_roi_align.roi_align_maxpool_bwd_plain(t(fmap), t(rois),
                                                     t(dout), 7, 1 / 16.0)
    close(got, ref, 1e-5)


def test_stem_dw_plain_matches_the_pallas_kernel(interpret):
    x = rand(1, 2, 32, 16, 3)
    g = rand(1, 2, 16, 8, 64, seed=1)
    ref = pallas_stem.stem_conv_s2d_dw(jnp.asarray(x), jnp.asarray(g),
                                       (5, 7, 7, 3, 64), temporal_pad=2,
                                       compute_dtype=jnp.float32)
    got = cuda_stem.stem_conv_dw_plain(t(x), t(g), 5)
    close(got, tpu_to_c2('conv1_w', np.asarray(ref)), 1e-4)


# --------------------------------------------------------------------------- #
# The space-to-depth packing of the bf16 stem dW kernel against lfb_tpu's
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize('temporal_pad', [0, 2])
def test_stem_s2d_pack_matches_lfb_tpu(temporal_pad):
    """``pack_x_s2d`` holds lfb_tpu's ``_pack_x`` (which drops the left
    column halo and pads the columns to 128 lanes); exact."""
    B, T, H, W = 2, 3, 20, 14
    x = rand(B, T, H, W, 3, seed=3)
    ref = np.asarray(pallas_stem._pack_x(jnp.asarray(x), temporal_pad,
                                         jnp.float32))
    hp, wp = H // 2, W // 2
    ref = ref.reshape(B, T + 2 * temporal_pad, 16, hp + 3, 128)
    ref = ref[:, temporal_pad:temporal_pad + T, :, :, :wp].transpose(
        0, 1, 3, 4, 2)
    got = cuda_stem.pack_x_s2d(t(x)).numpy()
    assert got.shape == (B, T, hp + 3, wp + 3, 16)
    np.testing.assert_array_equal(got[:, :, :, 2:2 + wp], ref)
    assert not got[:, :, :, :2].any() and not got[:, :, :, 2 + wp:].any()


@pytest.mark.parametrize('kt', [1, 5])
def test_stem_s2d_unpack_matches_lfb_tpu(kt):
    """``unpack_dw_s2d`` inverts the same packing as lfb_tpu's
    ``_unpack_dw4`` (whose packed dW is (kt, dh, c2) x (dw, co)); exact."""
    dw4 = rand(kt * 4 * 16, 4 * 64, seed=kt)
    ref = np.asarray(pallas_stem._unpack_dw4(jnp.asarray(dw4), kt, 3, 64))
    mine = dw4.reshape(kt, 4, 16, 4, 64).transpose(0, 1, 3, 2, 4)
    np.testing.assert_array_equal(cuda_stem.unpack_dw_s2d(t(mine)).numpy(),
                                  ref)


@pytest.mark.parametrize('H,W,kt', [(20, 18, 5), (21, 23, 3), (9, 12, 1)])
def test_stem_dw_over_the_s2d_packing_matches_lfb_tpu(H, W, kt):
    """The bf16 kernel's arithmetic on the CPU: dW of the packed 4 x 4 taps
    as one product per (frame, temporal tap, tap) over the packed x and g,
    unpacked, against ``jax.grad`` of lfb_tpu's conv: 1e-4 (odd sizes
    too)."""
    x = rand(2, 3, H, W, 3, seed=4)
    ho, wo = (H + 1) // 2, (W + 1) // 2
    g = rand(2, 3, ho, wo, 64, seed=5)
    xs = cuda_stem.pack_x_s2d(t(x))
    dw4 = torch.zeros(kt, 4, 4, 16, 64)
    for k in range(kt):
        for f in range(3):
            tin = f + k - kt // 2
            if 0 <= tin < 3:
                for tap in range(16):
                    dh, dw = divmod(tap, 4)
                    dw4[k, dh, dw] += torch.einsum(
                        'bhwc,bhwo->co', xs[:, tin, dh:dh + ho, dw:dw + wo],
                        t(g[:, f]))

    def jloss(w):
        out = jax_conv3d(jnp.asarray(x), w, strides=(1, 2, 2),
                         padding=(kt // 2, 3, 3))
        return jnp.sum(out * g)

    ref = jax.grad(jloss)(jnp.zeros((kt, 7, 7, 3, 64), jnp.float32))
    close(cuda_stem.unpack_dw_s2d(dw4), ref, 1e-4)


def unpack_w_desc(w_desc):
    """``pack_w_s2d``'s core-matrix layout (kt, dh, dw, co // 8, c16 // 8,
    co % 8, c16 % 8) back to W4 (kt, dh, dw, c16, co)."""
    kt = w_desc.shape[0]
    return w_desc.permute(0, 1, 2, 4, 6, 3, 5).reshape(kt, 4, 4, 16, 64)


@pytest.mark.parametrize('kt', [1, 3, 5])
def test_stem_pack_w_matches_lfb_tpu(kt):
    """``pack_w_s2d`` holds lfb_tpu's ``_pack_w`` (whose packed weights are
    (kt, dh, c16) x (dw, co)) through the documented core-matrix
    permutation; exact."""
    w = rand(kt, 7, 7, 3, 64, seed=kt)
    ref = np.asarray(pallas_stem._pack_w(jnp.asarray(w), jnp.float32))
    ref = ref.reshape(kt, 4, 16, 4, 64).transpose(0, 1, 3, 2, 4)
    got = cuda_stem.pack_w_s2d(t(tpu_to_c2('conv1_w', w)))
    assert tuple(got.shape) == (kt, 4, 4, 8, 2, 8, 8)
    np.testing.assert_array_equal(unpack_w_desc(got).numpy(), ref)


def stem_over_the_s2d_packing(x, w, kt):
    """The bf16 forward kernel's arithmetic on the CPU in f32: out (b, t,
    ho, wo) = sum over the temporal taps whose frame t + kt - kT/2 exists
    and the 16 (dh, dw) taps of packed pixel (ho + dh, wo + dw) of
    ``pack_x_s2d(x)`` . W4 of ``pack_w_s2d(w)``."""
    B, T, H, W, _ = x.shape
    ho, wo = (H + 1) // 2, (W + 1) // 2
    xs = cuda_stem.pack_x_s2d(t(x))
    w4 = unpack_w_desc(cuda_stem.pack_w_s2d(t(tpu_to_c2('conv1_w', w))))
    out = torch.zeros(B, T, ho, wo, 64)
    for f in range(T):
        for k in range(kt):
            tin = f + k - kt // 2
            if 0 <= tin < T:
                for tap in range(16):
                    dh, dw = divmod(tap, 4)
                    out[:, f] += torch.einsum(
                        'bhwc,co->bhwo', xs[:, tin, dh:dh + ho, dw:dw + wo],
                        w4[k, dh, dw])
    return out


@pytest.mark.parametrize('H,W,kt', [(32, 32, 1), (32, 32, 5), (32, 64, 1),
                                    (32, 64, 5)])
def test_stem_forward_over_the_s2d_packing_matches_the_pallas_kernel(
        interpret, H, W, kt):
    """Against ``pallas_stem.stem_conv_s2d`` in interpret mode, f32, inside
    its envelope (H/2 % 16 == 0, W/2 <= 128): 1e-4."""
    x = rand(1, 3, H, W, 3, seed=6)
    w = rand(kt, 7, 7, 3, 64, seed=7, scale=0.1)
    ref = pallas_stem.stem_conv_s2d(jnp.asarray(x), jnp.asarray(w),
                                    temporal_pad=kt // 2,
                                    compute_dtype=jnp.float32)
    assert ref is not None
    close(stem_over_the_s2d_packing(x, w, kt), ref, 1e-4)


@pytest.mark.parametrize('H,W', [(21, 23), (9, 12)])
def test_stem_forward_over_the_s2d_packing_matches_conv3d(H, W):
    """Odd sizes outside the Pallas envelope, kT 3 over T = 3 (the first
    and last frames reach padded frames), against lfb_tpu's conv3d: 1e-4."""
    x = rand(2, 3, H, W, 3, seed=8)
    w = rand(3, 7, 7, 3, 64, seed=9, scale=0.1)
    ref = jax_conv3d(jnp.asarray(x), jnp.asarray(w), strides=(1, 2, 2),
                     padding=(1, 3, 3))
    close(stem_over_the_s2d_packing(x, w, 3), ref, 1e-4)


# --------------------------------------------------------------------------- #
# The whole step
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize('name', ['flagship', 'charades'])
def test_lr_schedule_copy_matches_lfb_tpu(name):
    """The port's ``get_lr_at_iter`` at every iteration around the warm-up's
    end and each step boundary of the solver, and on a grid over the whole
    schedule (iterations 0 to MAX_ITER - 1); also under the other three
    policies."""
    cfg = (flagship_cfg if name == 'flagship' else charades_cfg)(
        {'NUM_GPUS': 1})
    solver = cfg.SOLVER
    assert opt.get_lr_at_iter is port_lr.get_lr_at_iter
    its = set(range(0, solver.MAX_ITER, 499)) | set(range(8))
    for edge in list(solver.STEPS) + [solver.MAX_ITER,
                                      solver.WARMUP.WARMUP_END_ITER]:
        its |= {edge - 1, edge, edge + 1}
    its = sorted(i for i in its if 0 <= i < solver.MAX_ITER)
    solvers = [solver]
    for policy in ('steps_with_lrs', 'steps_with_decay', 'step'):
        other = copy.deepcopy(solver)
        other.LR_POLICY, other.STEP_SIZE = policy, 3000
        solvers.append(other)
    for s in solvers:
        for it in its:
            assert port_lr.get_lr_at_iter(s, it) == get_lr_at_iter(s, it), (
                s.LR_POLICY, it)
    if name == 'flagship':
        assert solver.WARMUP.WARMUP_ON


@pytest.mark.parametrize('shape', [(5, 7, 7, 3, 64), (2560, 80), (80,)])
def test_tpu_to_c2_copy_matches_lfb_tpu(shape):
    a = rand(*shape, seed=len(shape))
    got = port_ckpt.tpu_to_c2('x', a)
    want = tpu_to_c2('x', a)
    assert got.shape == want.shape and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


def test_read_pkl_reads_what_lfb_tpu_writes(tmp_path):
    data = {'blobs': {'conv1_w': rand(4, 3, 1, 1, 1), 'pred_b': rand(3)},
            'model_iter': 7, 'lr': 0.01}
    path = str(tmp_path / 'weights.pkl')
    write_pkl(path, data)
    got = port_ckpt.read_pkl(path)
    assert set(got) == set(data) and got['model_iter'] == 7
    for name, value in data['blobs'].items():
        np.testing.assert_array_equal(got['blobs'][name], value)
    write_pkl(path, {b'blobs': {b'pred_b': data['blobs']['pred_b']}})
    assert list(port_ckpt.read_pkl(path)['blobs']) == ['pred_b']   # py2 keys


def test_sgd_state_round_trip():
    names = {'conv1_w': (5, 7, 7, 3, 64), 'pred_w': (2560, 80),
             'pred_b': (80,)}
    momentum = {k: rand(*s, seed=i) for i, (k, s) in enumerate(names.items())}
    state = params_from_jax(jax_opt.SGDState(momentum=momentum), device='cpu')
    assert isinstance(state, opt.SGDState)
    assert state.momentum['conv1_w'].shape == (64, 3, 5, 7, 7)
    np.testing.assert_array_equal(state.momentum['pred_w'][3, 100].numpy(),
                                  momentum['pred_w'][100, 3])
    back = params_to_jax(state)
    for k, v in momentum.items():
        np.testing.assert_array_equal(back.momentum[k], v, err_msg=k)


def test_each_step_factory_builds_the_model_once(monkeypatch):
    """``make_eval_step`` and ``make_train_step`` build the model's module
    tree when the step is made, and every call runs that one: two calls of
    each step build one backbone a step in all."""
    from lfb_tpu_torch.models.backbone import Backbone
    built = []
    init = Backbone.__init__

    def counted(self, *args, **kwargs):
        built.append(type(self))
        init(self, *args, **kwargs)

    monkeypatch.setattr(Backbone, '__init__', counted)
    cfg = flagship_cfg(STEP_CFG)
    spec = build_spec(cfg, 'train')
    params = port_model.init_params(spec, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    n, crop = 4, 32
    batch = {
        'data': t(rng.randint(0, 256, (2, 8, crop, crop, 3)).astype(np.uint8)),
        'proposals': t(np.stack([
            np.repeat(np.arange(2), 2).astype('f'),
            rng.uniform(0, crop / 2, n), rng.uniform(0, crop / 2, n),
            rng.uniform(crop / 2, crop, n), rng.uniform(crop / 2, crop, n)],
            axis=1).astype('f')),
        'lfb': t(rng.randn(n, spec.fbo.num_lfb_feat, 2048).astype('f')),
        'labels': t((rng.rand(n, 80) < 0.1).astype('f')),
        'box_mask': t(np.array([1, 1, 1, 0], 'f'))}

    eval_step = make_eval_step(build_spec(cfg, 'test'), with_loss=True)
    assert len(built) == 1
    for _ in range(2):
        out = eval_step(params, batch)
        assert bool(torch.isfinite(out['loss']))
    assert len(built) == 1

    train, frozen = split_params(spec, params)
    state = opt.init_state(params, set(frozen))
    step = make_train_step(spec, cfg.SOLVER)
    assert len(built) == 2
    generator = torch.Generator().manual_seed(0)
    for lr in (0.01, 0.02):
        train, frozen, state, aux = step(train, frozen, state, batch,
                                         generator, lr)
        assert bool(torch.isfinite(aux['loss']))
    assert built == [Backbone, Backbone]


def test_two_train_steps_match_lfb_tpu():
    """Two steps of the port's ``make_train_step`` against lfb_tpu's (mesh
    None) from the same params, on the same batch (with a padded box).

    Bounds, relative to the largest value of each lfb_tpu tensor: loss
    1e-5; momentum buffers 2e-3; params 2e-3 of the largest update plus
    1e-6 of the largest param (the update is ~1e-3 of the param, so the
    params' own f32 rounding shows at that scale).  Both sides run f32, but
    the sums of 50 layers' gradients are taken in other orders, and with
    these random weights a few near-zero ReLU gates and pooling maxima flip:
    the same step with plain PyTorch autograd in place of the three kernels'
    Functions differs from lfb_tpu by as much (3e-4 of the largest
    momentum)."""
    cfg = flagship_cfg(STEP_CFG)
    jspec = jax_models.build_spec(cfg, 'train')
    spec = build_spec(cfg, 'train')
    rng = np.random.RandomState(0)
    params = perturbed_params(jspec, rng)
    n, crop = 4, 32
    batch = {
        'data': rng.randint(0, 256, (2, 8, crop, crop, 3)).astype(np.uint8),
        'proposals': np.stack([
            np.repeat(np.arange(2), 2).astype('f'),
            rng.uniform(0, crop / 2, n), rng.uniform(0, crop / 2, n),
            rng.uniform(crop / 2, crop, n), rng.uniform(crop / 2, crop, n)],
            axis=1).astype('f'),
        'lfb': (rng.randn(n, jspec.fbo.num_lfb_feat, 2048) * 0.5).astype('f'),
        'labels': (rng.rand(n, 80) < 0.1).astype('f'),
        'box_mask': np.array([1, 1, 1, 0], 'f')}

    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jtrain, jfrozen = jax_split_params(jspec, jparams)
    jstate = jax_opt.init_state(jparams, jax_model.frozen_param_names(
        jspec, jparams))
    jstep = jax_make_train_step(jspec, cfg.SOLVER, mesh=None)
    port = params_from_jax(params, device='cpu')
    train, frozen = split_params(spec, port)
    state = opt.init_state(port, set(frozen))
    step = make_train_step(spec, cfg.SOLVER)
    generator = torch.Generator().manual_seed(0)
    real = batch['box_mask'] > 0
    for i, lr in enumerate((0.01, 0.02)):
        jtrain, jfrozen, jstate, jaux = jstep(
            jtrain, jfrozen, jstate,
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(i), jnp.float32(lr))
        with padding_rows.classifier_inputs() as seen:
            train, frozen, state, aux = step(
                train, frozen, state, {k: t(v) for k, v in batch.items()},
                generator, lr)
        np.testing.assert_allclose(aux['loss'].item(), float(jaux['loss']),
                                   rtol=1e-5)
        # The real rows as lfb_tpu's; the padding row's FBO part is 0.
        close(aux['prob'].numpy()[real], np.asarray(jaux['prob'])[real], 1e-5)
        padding_rows.assert_padding_rows(
            aux['prob'], padding_rows.padding_prob(
                seen[0], spec.fbo.latent_dim), batch['box_mask'])
    assert set(train) == set(jtrain) and set(state.momentum) == set(jtrain)
    back = params_to_jax(train)
    momentum = params_to_jax(state).momentum
    for name in jtrain:
        ref = np.asarray(jtrain[name])
        update = np.abs(ref - params[name]).max()
        np.testing.assert_allclose(
            back[name], ref, rtol=0,
            atol=2e-3 * update + 1e-6 * np.abs(params[name]).max(),
            err_msg=name)
        close(momentum[name], jstate.momentum[name], 2e-3)
    assert np.abs(momentum['conv1_w']).max() > 0
    for name in frozen:                       # frozen params never move
        np.testing.assert_array_equal(frozen[name].numpy(),
                                      tpu_to_c2(name, params[name]))

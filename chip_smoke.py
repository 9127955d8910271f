#!/usr/bin/env python3
"""Drive the lfb_tpu_torch port once on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; without a CUDA device, or
away from the rest of the repository, it exits non-zero before printing any
result):

1. Print the card's name and power limit, build the CUDA kernels of
   ``lfb_tpu_torch/csrc`` and print the build time, ptxas's registers and
   spills, and the tensor-core instructions (HMMA, HGMMA) that
   ``cuobjdump -sass`` finds in each attention kernel, the stem weight
   gradient and the fused bottleneck: the bf16 ones must have some.
2. Hold each kernel against its plain PyTorch version on the card, at the
   flagship shapes (every attention regime; the fused bottleneck at every
   identity-block shape of R101 at crop 256), and time both (median of
   CUDA-event timings, taken in turns), with one PyTorch call that computes
   the same function where there is one (``F.conv3d`` for the stem,
   ``F.scaled_dot_product_attention`` for attention, under the first of its
   backends that takes the shape; beside the fused bottleneck, the same
   block as the unfused bf16 path runs it), and the kernel's bound: the
   larger of its operations over the card's peak for their type and its
   bytes over the memory rate.
3. Hold the full-width model on the card (f32, kernels) against the same
   model on the CPU (f32, plain versions) on one clip: the flagship, and
   Charades with the fused bottleneck.
4. The flagship main path at full width: ``flagship_cfg()`` (R101-I3D-NL,
   3-layer FBO-NL, 300-row windows, T 32, crop 256), 16 clips x 4 boxes per
   batch, seeded perturbed weights, uint8 frames.  Phase A runs the bank
   extraction entry point (``extract_ava_bank``) over 2 batches, which
   returns the host bank; synthetic rows top it up to AVA scale (235 videos
   x 897 s, Poisson(2) rows per second); the bank goes to the card.  Phase B
   runs 3 batches of the eval step with that bank, then the same 3 batches
   again with ``TPU.PALLAS_BOTTLENECK`` (the fused identity blocks), whose
   prob must be within 2e-2 of the unfused prob and of the f32 model's.  Each kernel's launch
   counter is reset before the phase and must read exactly its launches per
   forward times the batches after it (no backward kernel runs).
5. The Charades main path at full width: ``charades_cfg()`` with
   ``TPU.PALLAS_BOTTLENECK`` (R101-I3D-NL without res5 dilation, clip-level
   head, 157 classes, 2-layer post-act FBO-NL over 20-row windows), 16 clips
   per batch.  Phase A runs ``extract_frame_bank`` over 2 batches;
   synthetic rows top the frame-level bank up to the Charades val split
   (1,814 videos of 15-45 s at 24 fps, a row every 12 frames); the
   ``FrameDeviceBank`` goes to the card; phase B runs 3 batches of the eval
   step with windows from ``gather_centers``.  Launches are checked as in 4.
6. Hold each backward kernel against its plain PyTorch version at the
   flagship train shapes (B = 8 clips x 4 boxes, T 32, crop 224), and the
   forward attention kernel's row log-sum-exp against ``torch.logsumexp``;
   time both, with the library call and the bound, as in phase 2 (cuDNN's
   weight gradient for the stem; SDPA's backward, its forward + backward
   less its forward, for attention).
7. One full-width f32 train step (1 clip x 4 boxes, dropout 0) on the card
   (kernels) against the same step on the CPU (plain versions), from the
   same params: the loss and every momentum buffer.
8. The train phase: ``make_train_step`` of ``build_spec(flagship_cfg(),
   'train')`` (crop 224, dropout 0.3 / 0.2, ``TPU.REMAT ''``), bf16 compute
   with f32 master weights, 8 clips x 4 boxes of uint8 frames per step, bank
   windows drawn from phase 4's AVA-scale device bank with a per-step
   generator: 2 warm-up and 5 timed steps, each with its launch counts
   checked, a finite loss, and nonzero momentum after it.

TF32 is off for matmuls and cuDNN convolutions throughout, so the plain
versions the kernels are compared with compute in full f32.

The second-to-last line is a JSON object with one entry per kernel (its
launches on the main path, max_abs_err, ms, plain_ms, bound_ms, bound_by,
library_ms, null where no one PyTorch call computes the same function);
the last line is ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile DIR`` runs none of the checks: it traces
the full-width phase-B forward, the same forward with the fused bottleneck
and then one train step with torch.profiler and writes the traces and
operator tables to DIR (see :func:`profile`).
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
B, BOXES_PER_CLIP = 16, 4
EXTRACT_BATCHES, INFER_BATCHES = 2, 3
TRAIN_B, TRAIN_WARMUP, TRAIN_STEPS = 8, 2, 5
AVA_VIDEOS = 235
CHARADES_VIDEOS = 1814                  # TEST.DATASET_SIZE, the val split
CHARADES_FRAMES = (15 * 24, 45 * 24)    # video lengths, 30 s on average
CHARADES_ROW_EVERY = 12                 # 24 fps / 2 bank clips per second
TIMING_ITERS = 10
CFG_OVERRIDES = {'NUM_GPUS': 1}
FUSED = {'TPU.PALLAS_BOTTLENECK': True}

KERNELS = {
    'stem_conv': dict(route='cuda', source='lfb_tpu_torch/csrc/stem_conv.cu',
                      replaces='lfb_tpu/ops/pallas_stem.py:212'),
    'stem_conv_dw': dict(route='cuda',
                         source='lfb_tpu_torch/csrc/stem_conv_dw.cu',
                         replaces='lfb_tpu/ops/pallas_stem.py:322'),
    'roi_align_maxpool': dict(
        route='cuda', source='lfb_tpu_torch/csrc/roi_align_maxpool.cu',
        replaces='lfb_tpu/ops/pallas_roi_align.py:186'),
    'roi_align_maxpool_bwd': dict(
        route='cuda', source='lfb_tpu_torch/csrc/roi_align_maxpool.cu',
        replaces='lfb_tpu/ops/pallas_roi_align.py:219'),
    'attention': dict(route='cuda', source='lfb_tpu_torch/csrc/attention.cu',
                      replaces='lfb_tpu/ops/pallas_attention.py:111'),
    'attention_bwd': dict(route='cuda',
                          source='lfb_tpu_torch/csrc/attention_bwd.cu',
                          replaces='lfb_tpu/ops/pallas_attention.py:153'),
    'fused_bottleneck': dict(route='cuda',
                             source='lfb_tpu_torch/csrc/fused_bottleneck.cu',
                             replaces='lfb_tpu/ops/pallas_bottleneck.py:170'),
}
_NO_BWD = {'stem_conv_dw': 0, 'roi_align_maxpool_bwd': 0, 'attention_bwd': 0}
# R101's identity blocks (2 + 3 + 22 + 2), each one fused launch.
_FUSED_LAUNCHES = {'fused_bottleneck': 29}
# Kernel launches per forward of each phase, and per train step.
PER_FORWARD = {'A': {'stem_conv': 1, 'roi_align_maxpool': 1, 'attention': 5,
                     'fused_bottleneck': 0, **_NO_BWD},
               'B': {'stem_conv': 1, 'roi_align_maxpool': 1, 'attention': 8,
                     'fused_bottleneck': 0, **_NO_BWD},
               'B fused': {'stem_conv': 1, 'roi_align_maxpool': 1,
                           'attention': 8, **_FUSED_LAUNCHES, **_NO_BWD},
               'Charades A': {'stem_conv': 1, 'roi_align_maxpool': 0,
                              'attention': 5, **_FUSED_LAUNCHES, **_NO_BWD},
               'Charades B': {'stem_conv': 1, 'roi_align_maxpool': 0,
                              'attention': 7, **_FUSED_LAUNCHES, **_NO_BWD},
               'train': {'stem_conv': 1, 'stem_conv_dw': 1,
                         'roi_align_maxpool': 1, 'roi_align_maxpool_bwd': 1,
                         'attention': 8, 'attention_bwd': 8,
                         'fused_bottleneck': 0}}
# R101's identity blocks at crop 256, B = 16: (label, x shape, Ci, kT,
# dilation, launches per flagship forward, per Charades forward).  res5 is
# dilated (d 2) in the flagship and not in Charades.
BLOCKS = [('res2 kT3', (B, 32, 64, 64, 256), 64, 3, 1, 2, 2),
          ('res3 kT1', (B, 16, 32, 32, 512), 128, 1, 1, 2, 2),
          ('res3 kT3', (B, 16, 32, 32, 512), 128, 3, 1, 1, 1),
          ('res4 kT3', (B, 16, 16, 16, 1024), 256, 3, 1, 11, 11),
          ('res4 kT1', (B, 16, 16, 16, 1024), 256, 1, 1, 11, 11),
          ('res5 kT3 d2', (B, 16, 16, 16, 2048), 512, 3, 2, 1, 0),
          ('res5 kT1 d2', (B, 16, 16, 16, 2048), 512, 1, 2, 1, 0),
          ('res5 kT3 d1', (B, 16, 16, 16, 2048), 512, 3, 1, 0, 1),
          ('res5 kT1 d1', (B, 16, 16, 16, 2048), 512, 1, 1, 0, 1)]


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def preamble():
    """Fail unless a CUDA device and the port are present; print the card."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device')
    import lfb_tpu_torch  # noqa: F401  (absent outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log('card: ' + card_line())
    log('torch {} cuda {}; TF32 off for matmul and cuDNN'.format(
        torch.__version__, torch.version.cuda))
    from lfb_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.library()
    log('built {} from lfb_tpu_torch/csrc in {:.1f} s (nvcc {:.1f} s)'.format(
        cuda_build.library_path().name, time.perf_counter() - t0,
        cuda_build.build_seconds))
    for line in cuda_build.build_log.splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            log('  ptxas: ' + line.strip())
    check_tensor_cores(cuda_build.library_path())


# The bf16 kernels that must run on the tensor cores (HMMA is the SASS of
# mma.sync, HGMMA of wgmma): attention forward and backward, the stem
# weight gradient and the fused bottleneck.
MMA_KERNELS = ('attn_mma_kernel', 'attn_bwd_dkdv_mma_kernel',
               'attn_bwd_dq_mma_kernel', 'stem_dw_mma_kernel',
               'fused_bottleneck_mma_kernel')


def check_tensor_cores(lib_path):
    """Count the tensor-core instructions of each kernel in the built
    library's SASS (``cuobjdump -sass``) and log those of the attention
    kernels and of ``MMA_KERNELS``; fail if a kernel of ``MMA_KERNELS`` has
    none."""
    import re
    import shutil
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    sass = subprocess.run([tool, '-sass', str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.match(r'\s*Function : (\S+)', line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and re.search(r'\bH(G)?MMA\b', line):
            counts[name] += 1
    for fn, n in sorted(counts.items()):
        if 'attn' in fn or any(kernel in fn for kernel in MMA_KERNELS):
            log('  sass: {} HMMA/HGMMA instructions in {}'.format(n, fn))
    for kernel in MMA_KERNELS:
        if not any(kernel in fn and n > 0 for fn, n in counts.items()):
            raise AssertionError('{}: no tensor-core instruction in its '
                                 'SASS'.format(kernel))


def cuda_ms(fn, iters):
    """Median CUDA-event time of ``fn`` in ms over ``iters`` runs."""
    import torch
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(label, kernel_fn, plain_fn, bound, iters, library_fn=None,
            library_label='library'):
    """Kernel vs plain on the same inputs; returns {err: max_abs_err, ms,
    plain_ms, library_ms}.  ``bound`` is relative to max |plain|; a function
    that returns a tuple (dq, dk, dv) is held output by output, each to its
    own max |plain|.  ``library_fn``, one PyTorch call computing the same
    function (or another yardstick, logged as ``library_label``), is timed
    in the same turns (library_ms None without one)."""
    import torch
    got, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, ref = (got,), (ref,)
    err = rel = 0.0
    for a, b in zip(got, ref, strict=True):
        a, b = a.float(), b.float()
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError('{}: shape {} vs {} or non-finite '
                                 'output'.format(label, tuple(a.shape),
                                                 tuple(b.shape)))
        e = (a - b).abs().max().item()
        err = max(err, e)
        rel = max(rel, e / max(b.abs().max().item(), 1e-30))
    del got, ref
    fns = [kernel_fn, plain_fn] + ([library_fn] if library_fn else [])
    times = [[] for _ in fns]
    for _ in range(max(iters, 1)):   # in turns: kernel, plain, library
        for fn, ts in zip(fns, times):
            ts.append(cuda_ms(fn, 1))
    ms, plain_ms, *lib = [statistics.median(ts) for ts in times]
    log('{}: max_abs_err {:.3e}, rel {:.3e} (bound {:.0e}); kernel {:.4f} ms, '
        'plain {:.4f} ms{}'.format(label, err, rel, bound, ms, plain_ms,
                                   ', {} {:.4f} ms'.format(library_label,
                                                           lib[0])
                                   if lib else ''))
    if not rel <= bound:
        raise AssertionError('{}: error {:.3e} of max|ref|, above {:.0e}'.format(
            label, rel, bound))
    return {'err': err, 'ms': ms, 'plain_ms': plain_ms,
            'library_ms': lib[0] if lib else None}


# Published H100 SXM peaks, dense (NVIDIA's H100 datasheet): bf16 on
# the tensor cores, f32 outside them, and the HBM3 rate.
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
HBM_BYTES_PER_S = 3.35e12


def least_ms(flops, nbytes, dtype):
    """The least time the card could take for ``flops`` operations of
    ``dtype`` ('bfloat16' or 'float32') and ``nbytes`` moved to or from
    device memory: (ms, 'operations' or 'bytes'), the larger of the two."""
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms,
                                                              'bytes')


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def add_bound(result, parts):
    """Set result's bound_ms to the sum of ``parts`` [(ms, bound_by)] and
    bound_by to what bounds the largest part."""
    result['bound_ms'] = sum(ms for ms, _ in parts)
    result['bound_by'] = max(parts)[1]
    return result


def roi_pixels(rois, size, scale=1 / 16):
    """Feature-map pixels the boxes reach (each box's extent on the map, one
    pixel more for the bilinear neighbours), counted once per clip."""
    seen = np.zeros((int(rois[:, 0].max()) + 1, size, size), bool)
    for b, x1, y1, x2, y2 in rois:
        r0, c0 = (max(0, min(size - 1, int(np.floor(v * scale))))
                  for v in (y1, x1))
        r1, c1 = (max(0, min(size - 1, int(np.floor(v * scale)) + 1))
                  for v in (y2, x2))
        seen[int(b), r0:r1 + 1, c0:c1 + 1] = True
    return int(seen.sum())


def sdpa_call(q, k, v, do, scale):
    """F.scaled_dot_product_attention on (B, N, C) inputs as one head, under
    the first backend (in PyTorch's order of preference) that takes them
    forward and backward; returns (forward fn, forward + backward fn,
    backend name).  The yardstick of ``library_ms``; the port never calls
    it."""
    import warnings
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q4, k4, v4 = (t[:, None].detach().requires_grad_(True) for t in (q, k, v))
    do4 = do[:, None]
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def fwd(backend=backend):
            with sdpa_kernel(backend), torch.no_grad():
                return F.scaled_dot_product_attention(q4, k4, v4,
                                                      scale=scale)[:, 0]

        def fwd_bwd(backend=backend):
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
                return torch.autograd.grad(out, (q4, k4, v4), do4)

        try:
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                fwd()
                fwd_bwd()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return fwd, fwd_bwd, backend.name
    raise AssertionError('no SDPA backend takes q{} k{}'.format(
        tuple(q.shape), tuple(k.shape)))


def rand_rois(rng, n_clips, boxes, crop):
    n = n_clips * boxes
    return np.stack([
        np.repeat(np.arange(n_clips), boxes).astype(np.float32),
        rng.uniform(0, crop / 2, n), rng.uniform(0, crop / 2, n),
        rng.uniform(crop / 2, crop, n), rng.uniform(crop / 2, crop, n)],
        axis=1).astype(np.float32)


def check_kernels(iters=TIMING_ITERS):
    """Phase 2: each kernel vs its plain version at the flagship shapes, with
    its bound and, where one PyTorch call computes the same function, that
    call's time.

    Bounds, relative to max |plain|: bf16 outputs 1e-2 (both sides round an
    f32 accumulation to bf16, 2^-8 apart at most twice over); f32 outputs
    1e-5 (f32 sums of at most a few thousand terms in another order).
    """
    import torch
    import torch.nn.functional as F
    from lfb_tpu_torch.ops import cuda_attention, cuda_roi_align, cuda_stem
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    results = {}

    x = torch.randint(0, 256, (B, 32, 256, 256, 3), generator=g, device=dev)
    x = ((x.float() / 255 - 0.45) / 0.225).to(torch.bfloat16)
    w = torch.randn((64, 3, 5, 7, 7), generator=g, device=dev) * (2 / 735) ** .5
    x_cl = x.permute(0, 4, 1, 2, 3)                  # channels-last view
    w_cl = w.to(torch.bfloat16, memory_format=torch.channels_last_3d)
    r = compare(
        'stem_conv x{} bf16'.format(tuple(x.shape)),
        lambda: cuda_stem.stem_conv(x, w, temporal_pad=2),
        lambda: cuda_stem.stem_conv_plain(x, w, 2), 1e-2, iters,
        lambda: F.conv3d(x_cl, w_cl, None, (1, 2, 2), (2, 3, 3)))
    out_elems = B * 32 * 128 * 128 * 64
    results['stem_conv'] = add_bound(dict(
        r, tolerance='1e-2',
        library='F.conv3d (cuDNN, bf16, channels-last)'), [least_ms(
        2 * out_elems * 735, nbytes(x, w) + 2 * out_elems, 'bfloat16')])
    del x, x_cl

    fmap = torch.relu(torch.randn((B, 16, 16, 2048), generator=g, device=dev))
    rois_np = rand_rois(rng, B, BOXES_PER_CLIP, 256)
    rois = torch.from_numpy(rois_np).to(dev)
    r = compare(
        'roi_align_maxpool fmap{} rois{} f32'.format(tuple(fmap.shape),
                                                     tuple(rois.shape)),
        lambda: cuda_roi_align.roi_align_maxpool(fmap, rois),
        lambda: cuda_roi_align.roi_align_maxpool_plain(fmap, rois), 1e-5,
        iters)
    results['roi_align_maxpool'] = add_bound(dict(r, tolerance='1e-5'), [
        least_ms(0, roi_pixels(rois_np, 16) * 2048 * 4 + nbytes(rois)
                 + rois.shape[0] * 2048 * 4, 'float32')])

    # (label, B, Nq, Nk, C, dtype, calls per phase-B forward)
    regimes = [('res3 NL', 64, 4096, 1024, 256, torch.bfloat16, 2),
               ('res4 NL', 16, 4096, 1024, 512, torch.bfloat16, 3),
               ('FBO-NL', 64, 1, 300, 512, torch.float32, 3)]
    total = {'err': 0.0, 'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0}
    parts, backends = [], []
    for label, b, nq, nk, c, dtype, calls in regimes:
        q, k, v = (torch.randn((b, n, c), generator=g, device=dev).to(dtype)
                   for n in (nq, nk, nk))
        lib_fwd, _, backend = sdpa_call(q, k, v, q, c ** -0.5)
        backends.append('{} {}'.format(label, backend))
        r = compare(
            'attention {} q{} k{} {}'.format(label, (b, nq, c), (b, nk, c),
                                            str(dtype).split('.')[-1]),
            lambda: cuda_attention.fused_attention(q, k, v, scale=c ** -0.5),
            lambda: cuda_attention.attention_plain(q, k, v, c ** -0.5),
            1e-2 if dtype == torch.bfloat16 else 1e-5, iters, lib_fwd)
        log('  SDPA backend for {}: {}'.format(label, backend))
        total['err'] = max(total['err'], r['err'])
        for key in ('ms', 'plain_ms', 'library_ms'):
            total[key] += calls * r[key]
        ms, by = least_ms(4 * b * nq * nk * c, 2 * nbytes(q) + nbytes(k, v),
                          str(dtype).split('.')[-1])
        parts.append((calls * ms, by))
    log('attention, the 8 calls of one phase-B forward: kernel {:.3f} ms, '
        'plain {:.3f} ms, SDPA {:.3f} ms'.format(
            total['ms'], total['plain_ms'], total['library_ms']))
    results['attention'] = add_bound(dict(
        total, tolerance='1e-5 f32, 1e-2 bf16',
        library='F.scaled_dot_product_attention ({})'.format(
            ', '.join(backends))), parts)
    del q, k, v
    results['fused_bottleneck'] = check_bottleneck(g, iters)
    return results


def bottleneck_params(c, ci, kt, g):
    """Folded block weights (port layout) at fan-in scale, branch2c at 0.2
    of it as in :func:`perturbed_params`, and 0.1 * N(0, 1) biases."""
    import torch
    dev = g.device

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    return (randn(ci, c, kt, 1, 1) * (kt * c) ** -0.5, 0.1 * randn(ci),
            randn(ci, ci, 1, 3, 3) * (9 * ci) ** -0.5, 0.1 * randn(ci),
            randn(c, ci, 1, 1, 1) * 0.2 * ci ** -0.5, 0.1 * randn(c))


def unfused_block(shape, ci, kt, d, p):
    """The identity block as the default (unfused) path runs it, from the
    folded weights with unit affine scales: ``models/backbone.py``'s
    ``Bottleneck`` (three cuDNN convolutions, the affine, ReLU and residual
    passes) in the flagship spec's bf16."""
    import torch
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.backbone import Bottleneck
    from lfb_tpu_torch.models.spec import build_spec
    spec = build_spec(flagship_cfg(CFG_OVERRIDES), 'test')
    c = shape[-1]
    params = {}
    for branch, w, bias in (('a', p[0], p[1]), ('b', p[2], p[3]),
                            ('c', p[4], p[5])):
        params['blk_branch2{}_w'.format(branch)] = w
        params['blk_branch2{}_bn_s'.format(branch)] = torch.ones_like(bias)
        params['blk_branch2{}_bn_b'.format(branch)] = bias
    block = Bottleneck(spec, 'blk', dim_in=c, dim_out=c, stride=1,
                       temp_stride=1, use_temp_conv=kt // 2, dilation=d)

    def run(x):
        with torch.inference_mode():
            return block(params, x, False)

    return run


def check_bottleneck(g, iters):
    """The fused bottleneck (bf16) vs its plain version (f32 cuDNN
    convolutions on the same bf16-rounded operands, intermediates rounded
    to bf16) at each identity-block shape of R101 at crop 256.  Bound 1e-2
    of max |plain|: both sides round h1, h2 and the output to bf16 (2^-8).
    Beside it, the same block as the default bf16 path runs it
    (:func:`unfused_block`), timed in the same turns."""
    import torch
    from lfb_tpu_torch.ops import cuda_bottleneck as cb
    err, totals = 0.0, {'flagship': [0.0, 0.0, 0.0],
                        'Charades': [0.0, 0.0, 0.0]}
    parts = []
    for label, shape, ci, kt, d, n_ava, n_charades in BLOCKS:
        x = torch.relu(torch.randn(shape, generator=g, device=g.device))
        x = x.to(torch.bfloat16)
        p = bottleneck_params(shape[-1], ci, kt, g)
        unfused = unfused_block(shape, ci, kt, d, p)
        r = compare(
            'fused_bottleneck {} x{} Ci {} bf16'.format(label, shape, ci),
            lambda: cb.fused_identity_bottleneck(x, *p, temporal_pad=kt // 2,
                                                 dilation=d),
            lambda: cb.fused_identity_bottleneck_plain(
                x, *p, temporal_pad=kt // 2, dilation=d), 1e-2, iters,
            lambda: unfused(x), 'unfused bf16 block')
        err = max(err, r['err'])
        for name, n in (('flagship', n_ava), ('Charades', n_charades)):
            totals[name][0] += n * r['ms']
            totals[name][1] += n * r['plain_ms']
            totals[name][2] += n * r['library_ms']
        pixels, c = x.numel() // shape[-1], shape[-1]
        ms, by = least_ms(2 * pixels * (c * ci * kt + 9 * ci * ci + ci * c),
                          2 * nbytes(x) + 2 * (c * ci * kt + 9 * ci * ci
                                               + ci * c), 'bfloat16')
        parts.append((n_ava * ms, by))
        del x
    for name, (ms, plain_ms, unfused_ms) in totals.items():
        log('fused_bottleneck, the 29 launches of one {} forward: kernel '
            '{:.3f} ms, plain {:.3f} ms, the unfused bf16 blocks {:.3f} '
            'ms'.format(name, ms, plain_ms, unfused_ms))
    return add_bound({'err': err, 'ms': totals['flagship'][0],
                      'plain_ms': totals['flagship'][1], 'library_ms': None,
                      'tolerance': '1e-2'}, parts)


def perturbed_params(spec, device):
    """Reference init, then every all-zero tensor (biases, zero-init NL and
    FBO output convs) drawn as 0.05 * N(0, 1), so every path reaches the
    logits, and each residual branch's last scale (branch2c) set near 0.2:
    at the reference's gamma of 1 the 33 random blocks would grow the
    activations about 1.4x each."""
    import torch
    from lfb_tpu_torch.models.model import init_params
    g = torch.Generator(device=device).manual_seed(SEED)
    params = init_params(spec, g)
    for name, value in params.items():
        if name.endswith('_branch2c_bn_s'):
            params[name] = 0.2 + 0.02 * torch.randn(value.shape, generator=g,
                                                    device=device)
        elif not value.any():
            params[name] = 0.05 * torch.randn(value.shape, generator=g,
                                              device=device)
    return params


def make_clip_batch(spec, rng, device, *, n_clips=B, with_lfb=False):
    """A clip-level (Charades) batch: uint8 frames and, for phase B, either
    explicit bank windows ('lfb') or the device bank's (video, center)
    keys, centers inside every video's length."""
    import torch
    crop, t = spec.crop_size, spec.video_length
    batch = {'data': rng.integers(0, 256, (n_clips, t, crop, crop, 3),
                                  np.uint8)}
    if with_lfb:
        batch['lfb'] = np.abs(rng.standard_normal(
            (n_clips, spec.fbo.num_lfb_feat, 2048), np.float32)) * 0.5
    elif spec.fbo.enabled and not spec.lfb_infer_only:
        batch['lfb_video_idx'] = rng.integers(0, CHARADES_VIDEOS, n_clips,
                                              dtype=np.int32)
        batch['lfb_center'] = rng.integers(0, CHARADES_FRAMES[0], n_clips,
                                           dtype=np.int32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def make_batch(spec, rng, device, *, n_clips=B, boxes=BOXES_PER_CLIP,
               with_lfb=False, with_labels=False):
    import torch
    crop, t = spec.crop_size, spec.video_length
    n = n_clips * boxes
    batch = {
        'data': rng.integers(0, 256, (n_clips, t, crop, crop, 3), np.uint8),
        'proposals': rand_rois(rng, n_clips, boxes, crop),
        'metadata': np.stack([
            rng.integers(0, AVA_VIDEOS, n), rng.integers(902, 1799, n),
            np.full(n, 400), np.full(n, 600)], axis=1).astype(np.float32),
        'box_mask': np.ones(n, np.float32),
    }
    if with_lfb:
        batch['lfb'] = np.abs(rng.standard_normal(
            (n, spec.fbo.num_lfb_feat, 2048), np.float32)) * 0.5
    if with_labels:
        batch['labels'] = (rng.random((n, spec.num_classes)) < 0.1).astype(
            np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def reference_check(cfg):
    """Phase 3: full width, one clip, f32: kernels on the card vs plain
    versions on the CPU, for the flagship and for Charades with the fused
    bottleneck (all 29 identity blocks launch it on the card).  Bound
    2e-3 x max|CPU| (f32 sums through 101 layers, taken in other orders by
    cuDNN, the kernels and the CPU)."""
    import torch
    from lfb_tpu_torch.config import charades_cfg, flagship_cfg
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.ops import cuda_bottleneck
    f32 = {'NUM_GPUS': 1, 'TPU.COMPUTE_DTYPE': 'float32'}
    spec = build_spec(flagship_cfg(f32), 'test')
    batch = make_batch(spec, np.random.default_rng(SEED + 1), 'cuda',
                       n_clips=1, boxes=2, with_lfb=True)
    hold_card_against_cpu('flagship', spec, batch,
                          ('box_pooled', 'logits', 'prob'))
    spec = build_spec(charades_cfg({**f32, **FUSED}), 'test')
    batch = make_clip_batch(spec, np.random.default_rng(SEED + 8), 'cuda',
                            n_clips=1, with_lfb=True)
    before = cuda_bottleneck.LAUNCHES
    hold_card_against_cpu('Charades, fused bottleneck', spec, batch,
                          ('pool5', 'logits', 'prob'))
    if cuda_bottleneck.LAUNCHES - before != _FUSED_LAUNCHES['fused_bottleneck']:
        raise AssertionError('Charades reference: {} fused launches'.format(
            cuda_bottleneck.LAUNCHES - before))


def hold_card_against_cpu(label, spec, batch, keys):
    import torch
    from lfb_tpu_torch.models.model import forward
    params = perturbed_params(spec, torch.device('cuda'))
    t0 = time.perf_counter()
    gpu = forward(spec, params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu = forward(spec, {k: v.cpu() for k, v in params.items()},
                  {k: v.cpu() for k, v in batch.items()})
    t2 = time.perf_counter()
    for key in keys:
        got, ref = gpu[key].float().cpu(), cpu[key].float()
        err = (got - ref).abs().max().item()
        scale = max(ref.abs().max().item(), 1e-30)
        log('reference {} {}: card vs CPU max_abs_err {:.3e}, rel {:.3e} '
            '(bound 2e-03)'.format(label, key, err, err / scale))
        if not (torch.isfinite(got).all() and err <= 2e-3 * scale):
            raise AssertionError('reference check failed for {} {}'.format(
                label, key))
    log('reference {} forward: card {:.1f} s (first call), CPU {:.1f} '
        's'.format(label, t1 - t0, t2 - t1))


def synthetic_frame_bank(host_bank, rng):
    """Top the Charades ``host_bank`` up to the val split: every video gets
    a length of 15-45 s at 24 fps and a row at each bank frame it lacks
    (frames 11, 23, ..., as ``lfb_tpu.data.charades.get_lfb_frames``), from
    one tiled random block."""
    lengths = rng.integers(CHARADES_FRAMES[0], CHARADES_FRAMES[1] + 1,
                           CHARADES_VIDEOS)
    total = int((lengths // CHARADES_ROW_EVERY).sum())
    block = np.abs(rng.standard_normal((4096, 2048), np.float32)) * 0.5
    feats = np.tile(block, (-(-total // 4096), 1))[:total]
    pos = 0
    for v, n in enumerate(lengths.tolist()):
        frames = host_bank.setdefault(v, {})
        for f in range(CHARADES_ROW_EVERY - 1, n, CHARADES_ROW_EVERY):
            frames.setdefault(f, feats[pos])
            pos += 1
    return host_bank


def synthetic_host_bank(host_bank, rng):
    """Top ``host_bank`` up to AVA scale: every (video, sec) it lacks gets
    Poisson(2) rows (clipped to 25) from one tiled random block."""
    from lfb_tpu_torch.bank.device_bank import AVA_NUM_SECS, AVA_SEC_BASE
    counts = rng.poisson(2.0, size=(AVA_VIDEOS, AVA_NUM_SECS)).clip(0, 25)
    total = int(counts.sum())
    block = np.abs(rng.standard_normal((4096, 2048), np.float32)) * 0.5
    feats = np.tile(block, (-(-total // 4096), 1))[:total]
    pos = 0
    for v in range(AVA_VIDEOS):
        secs = host_bank.setdefault(v, {})
        for si in np.nonzero(counts[v])[0]:
            n = int(counts[v, si])
            secs.setdefault(int(si) + AVA_SEC_BASE, list(feats[pos:pos + n]))
            pos += n
    return host_bank


def timed(batches, stamps):
    """Yield ``batches``, appending the host clock to ``stamps`` once the
    card is idle before each batch and after the last: ``stamps`` then
    bounds each batch's work, whatever consumes the batches."""
    import torch
    for batch in batches:
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        yield batch
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())


def counters():
    """Kernel name -> (wrapper module, name of its launch counter)."""
    from lfb_tpu_torch.ops import (cuda_attention, cuda_bottleneck,
                                   cuda_roi_align, cuda_stem)
    return {'fused_bottleneck': (cuda_bottleneck, 'LAUNCHES'),
            'stem_conv': (cuda_stem, 'LAUNCHES'),
            'stem_conv_dw': (cuda_stem, 'DW_LAUNCHES'),
            'roi_align_maxpool': (cuda_roi_align, 'LAUNCHES'),
            'roi_align_maxpool_bwd': (cuda_roi_align, 'BWD_LAUNCHES'),
            'attention': (cuda_attention, 'LAUNCHES'),
            'attention_bwd': (cuda_attention, 'BWD_LAUNCHES')}


def reset_launches():
    for module, counter in counters().values():
        setattr(module, counter, 0)


def read_launches():
    return {name: getattr(module, counter)
            for name, (module, counter) in counters().items()}


def run_phase(label, fn, batches, per_forward):
    """Call ``fn`` on the batches (through :func:`timed`) with every launch
    counter at 0 just before and read just after; check the counters.
    Returns (ms per batch after the first, fn's result, launches)."""
    stamps = []
    reset_launches()
    result = fn(timed(batches, stamps))
    launches = read_launches()
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    want = {name: n * len(batches) for name, n in per_forward.items()}
    log('phase {}: launches {} (want {}); ms per batch {}'.format(
        label, launches, want, ['{:.1f}'.format(m) for m in ms]))
    if launches != want or len(ms) != len(batches):
        raise AssertionError('phase {}: kernel launch counts {} != {}'.format(
            label, launches, want))
    steady = statistics.mean(ms[1:])
    log('phase {}: {:.1f} ms per batch after the first, {:.1f} clips/s'.format(
        label, steady, B / (steady / 1e3)))
    return steady, result, launches


def main_path(cfg):
    """Phase 4: bank extraction, the AVA-scale bank, FBO inference, unfused
    and fused."""
    import torch
    from lfb_tpu_torch.bank.device_bank import build_device_bank
    from lfb_tpu_torch.bank.lfb import extract_ava_bank
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.train.steps import make_eval_step
    dev = torch.device('cuda')
    spec_a = build_spec(cfg, 'test', lfb_infer_only=True)
    spec_b = build_spec(cfg, 'test')
    params = perturbed_params(spec_b, dev)
    rng = np.random.default_rng(SEED + 2)
    torch.cuda.reset_peak_memory_stats()

    # Phase A through the entry point: each batch's time includes its
    # features' copy to the host bank; building the bank from the collected
    # features (construct_ava_lfb, 128 rows) follows the last stamp.
    batches = [make_batch(spec_a, rng, dev) for _ in range(EXTRACT_BATCHES)]
    ms_a, host_bank, launches_a = run_phase(
        'A (bank extraction)', lambda bs: extract_ava_bank(spec_a, params, bs),
        batches, PER_FORWARD['A'])
    feats = [f for s in host_bank.values() for fs in s.values() for f in fs]
    if len(feats) != EXTRACT_BATCHES * B * BOXES_PER_CLIP or not all(
            f.shape == (2048,) and np.isfinite(f).all() for f in feats):
        raise AssertionError('phase A: bad host bank')
    del batches

    t0 = time.perf_counter()
    host_bank = synthetic_host_bank(host_bank, rng)
    t1 = time.perf_counter()
    bank = build_device_bank(cfg, host_bank, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del host_bank
    bank_gb = bank.feats.numel() * bank.feats.element_size() / 2 ** 30
    log('bank: {} rows ({} extracted) x 2048 {} = {:.2f} GiB on the card; '
        'synthesis {:.1f} s, build + copy {:.1f} s'.format(
            bank.feats.shape[0], len(feats),
            str(bank.feats.dtype).split('.')[-1], bank_gb, t1 - t0, t2 - t1))

    infer = make_eval_step(spec_b, bank=bank, bank_seed=SEED)
    batches = [make_batch(spec_b, rng, dev) for _ in range(INFER_BATCHES)]
    ms_b, outs, launches_b = run_phase(
        'B (FBO inference, device bank)',
        lambda bs: [infer(params, b) for b in bs], batches, PER_FORWARD['B'])
    for out in outs:
        prob = out['prob']
        if tuple(prob.shape) != (B * BOXES_PER_CLIP, spec_b.num_classes) or \
                not (torch.isfinite(out['logits']).all()
                     and bool(((prob >= 0) & (prob <= 1)).all())):
            raise AssertionError('phase B: bad logits/prob')
    log('two-phase: {:.1f} clips/s (each clip once per phase); peak device '
        'memory {:.2f} GiB'.format(2 * B / ((ms_a + ms_b) / 1e3),
                                  torch.cuda.max_memory_allocated() / 2 ** 30))

    # The same batches, bank and params through the fused identity blocks.
    infer = make_eval_step(
        build_spec(flagship_cfg({**CFG_OVERRIDES, **FUSED}), 'test'),
        bank=bank, bank_seed=SEED)
    ms_f, outs_f, launches_f = run_phase(
        'B fused (TPU.PALLAS_BOTTLENECK)',
        lambda bs: [infer(params, b) for b in bs], batches,
        PER_FORWARD['B fused'])
    # Both bf16 paths against the same batches through the f32 model.  The
    # unfused bf16 path itself lies about 1.1e-2 from it (max over the
    # batch's probs), so the fused path is held to 2e-2 of each.
    infer = make_eval_step(build_spec(flagship_cfg(
        {**CFG_OVERRIDES, 'TPU.COMPUTE_DTYPE': 'float32'}), 'test'),
        bank=bank, bank_seed=SEED)
    f32 = [infer(params, b) for b in batches]

    def dist(xs, ys):
        d = torch.cat([(x['prob'].float() - y['prob'].float()).abs().flatten()
                       for x, y in zip(xs, ys, strict=True)])
        return d.max().item(), d.mean().item()

    (diff, diff_mean), (d_fused, _), (d_unfused, _) = (
        dist(outs_f, outs), dist(outs_f, f32), dist(outs, f32))
    log('phase B fused vs unfused: {:.1f} vs {:.1f} ms per batch; prob max '
        '|diff| {:.3e} (mean {:.3e}; bound 2e-2); max |diff| from the f32 '
        'model: fused {:.3e} (bound 2e-2), unfused {:.3e}'.format(
            ms_f, ms_b, diff, diff_mean, d_fused, d_unfused))
    if not (diff <= 2e-2 and d_fused <= 2e-2):
        raise AssertionError('phase B fused: prob {:.3e} from the unfused and '
                             '{:.3e} from the f32 prob'.format(diff, d_fused))
    return {k: launches_a[k] + launches_b[k] + launches_f[k]
            for k in launches_a}, bank


def charades_path():
    """Phase 5: the Charades main path with the fused bottleneck: frame-level
    bank extraction, the val-scale frame bank on the card, FBO inference
    with windows gathered from it."""
    import torch
    from lfb_tpu_torch.bank.device_bank import build_device_bank
    from lfb_tpu_torch.bank.lfb import extract_frame_bank
    from lfb_tpu_torch.config import charades_cfg
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.train.steps import make_eval_step
    dev = torch.device('cuda')
    cfg = charades_cfg({**CFG_OVERRIDES, **FUSED})
    spec_a = build_spec(cfg, 'test', lfb_infer_only=True)
    spec_b = build_spec(cfg, 'test')
    params = perturbed_params(spec_b, dev)
    rng = np.random.default_rng(SEED + 7)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # The sweep's clip list: distinct (video, bank frame) pairs.
    n = EXTRACT_BATCHES * B
    clips = [(int(v), CHARADES_ROW_EVERY * int(k) - 1) for v, k in zip(
        rng.choice(CHARADES_VIDEOS, n, replace=False),
        rng.integers(1, CHARADES_FRAMES[0] // CHARADES_ROW_EVERY + 1, n))]
    batches = [make_clip_batch(spec_a, rng, dev)
               for _ in range(EXTRACT_BATCHES)]
    ms_a, host_bank, launches_a = run_phase(
        'Charades A (frame-level bank extraction)',
        lambda bs: extract_frame_bank(spec_a, params, bs, clips, 'charades'),
        batches, PER_FORWARD['Charades A'])
    feats = [f for frames in host_bank.values() for f in frames.values()]
    if len(feats) != n or not all(f.shape == (2048,) and np.isfinite(f).all()
                                  for f in feats):
        raise AssertionError('Charades phase A: bad host bank')
    del batches

    t0 = time.perf_counter()
    host_bank = synthetic_frame_bank(host_bank, rng)
    t1 = time.perf_counter()
    bank = build_device_bank(cfg, host_bank, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del host_bank
    log('Charades bank: {} rows ({} extracted) x 2048 {} = {:.2f} GiB on the '
        'card, {} videos x {} table columns; synthesis {:.1f} s, build + copy '
        '{:.1f} s'.format(
            bank.feats.shape[0], n, str(bank.feats.dtype).split('.')[-1],
            bank.feats.numel() * bank.feats.element_size() / 2 ** 30,
            bank.num_videos(), bank.frame_ids.shape[1], t1 - t0, t2 - t1))

    infer = make_eval_step(spec_b, bank=bank)
    batches = [make_clip_batch(spec_b, rng, dev)
               for _ in range(INFER_BATCHES)]
    ms_b, outs, launches_b = run_phase(
        'Charades B (FBO inference, frame device bank)',
        lambda bs: [infer(params, b) for b in bs], batches,
        PER_FORWARD['Charades B'])
    for out in outs:
        prob = out['prob']
        if tuple(prob.shape) != (B, spec_b.num_classes) or \
                not (torch.isfinite(out['logits']).all()
                     and bool(((prob >= 0) & (prob <= 1)).all())):
            raise AssertionError('Charades phase B: bad logits/prob')
    log('Charades two-phase: {:.1f} clips/s (each clip once per phase); '
        'peak device memory {:.2f} GiB, {:.2f} GiB of it held from the '
        'flagship phases (their bank and params)'.format(
            2 * B / ((ms_a + ms_b) / 1e3),
            torch.cuda.max_memory_allocated() / 2 ** 30, held / 2 ** 30))
    return {k: launches_a[k] + launches_b[k] for k in launches_a}


def busy_us(intervals, t0, t1):
    """Length of the union of the (start, end) ``intervals`` inside
    [t0, t1]."""
    busy, end = 0.0, t0
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, t1)
        if b > a:
            busy += b - a
            end = b
    return busy


def check_backward_kernels(iters=TIMING_ITERS):
    """Phase 6: each backward kernel vs its plain version at the flagship
    train shapes (B = 8 clips x 4 boxes, T 32, crop 224), and the forward
    attention kernel's row log-sum-exp vs ``torch.logsumexp``.

    Bounds, relative to max |plain| of each output: attention 1e-5 in f32
    and 1e-2 in bf16 (both sides form f32 gradients from the same inputs, in
    other orders); lse 1e-5; RoI 1e-5 (f32 sums of at most 16 x 4 terms per
    bin and box); stem dW 1e-2 (cuDNN's bf16 weight gradient rounds its
    output to bf16, the kernel keeps its f32 sum).
    """
    import torch
    from lfb_tpu_torch.ops import cuda_attention, cuda_roi_align, cuda_stem
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    rng = np.random.default_rng(SEED + 4)
    n = TRAIN_B * BOXES_PER_CLIP
    results = {}

    x = torch.randint(0, 256, (TRAIN_B, 32, 224, 224, 3), generator=g,
                      device=dev)
    x = ((x.float() / 255 - 0.45) / 0.225).to(torch.bfloat16)
    dy = torch.randn((TRAIN_B, 32, 112, 112, 64), generator=g,
                     device=dev).to(torch.bfloat16)
    x_cl, dy_cl = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)
    r = compare(
        'stem_conv_dw x{} dOut{} bf16'.format(tuple(x.shape), tuple(dy.shape)),
        lambda: cuda_stem.stem_conv_dw(x, dy, 5),
        lambda: cuda_stem.stem_conv_dw_plain(x, dy, 5), 1e-2, iters,
        lambda: torch.nn.grad.conv3d_weight(x_cl, (64, 3, 5, 7, 7), dy_cl,
                                            stride=(1, 2, 2),
                                            padding=(2, 3, 3)))
    results['stem_conv_dw'] = add_bound(dict(
        r, tolerance='1e-2',
        library='torch.nn.grad.conv3d_weight (cuDNN, bf16)'), [least_ms(
        2 * dy.numel() * 735, nbytes(x, dy) + 64 * 735 * 4, 'bfloat16')])
    del x, dy, x_cl, dy_cl

    fmap = torch.relu(torch.randn((TRAIN_B, 14, 14, 2048), generator=g,
                                  device=dev))
    rois_np = rand_rois(rng, TRAIN_B, BOXES_PER_CLIP, 224)
    rois = torch.from_numpy(rois_np).to(dev)
    dout = torch.randn((n, 2048), generator=g, device=dev)
    r = compare(
        'roi_align_maxpool_bwd fmap{} rois{} f32'.format(tuple(fmap.shape),
                                                         tuple(rois.shape)),
        lambda: cuda_roi_align.roi_align_maxpool_bwd(fmap, rois, dout),
        lambda: cuda_roi_align.roi_align_maxpool_bwd_plain(fmap, rois, dout),
        1e-5, iters)
    # The map's pixels the boxes reach are read; the whole gradient map is
    # written.
    results['roi_align_maxpool_bwd'] = add_bound(dict(r, tolerance='1e-5'), [
        least_ms(0, roi_pixels(rois_np, 14) * 2048 * 4 + nbytes(fmap, rois,
                                                                 dout),
                 'float32')])
    del fmap

    # (label, B, Nq, Nk, C, dtype, calls per train step)
    regimes = [('res3 NL', 32, 3136, 784, 256, torch.bfloat16, 2),
               ('res4 NL', 8, 3136, 784, 512, torch.bfloat16, 3),
               ('FBO-NL', n, 1, 300, 512, torch.float32, 3)]
    total = {'err': 0.0, 'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0}
    parts, backends = [], []
    for label, b, nq, nk, c, dtype, calls in regimes:
        q, k, v, do = (torch.randn((b, m, c), generator=g, device=dev).to(dtype)
                       for m in (nq, nk, nk, nq))
        scale = c ** -0.5
        out, lse = cuda_attention.fused_attention_lse(q, k, v, scale=scale)
        ref_lse = torch.logsumexp(
            torch.matmul(q.float(), k.float().transpose(1, 2)) * scale, dim=-1)
        lse_rel = ((lse - ref_lse).abs().max() / ref_lse.abs().max()).item()
        log('attention lse {}: rel err {:.3e} vs torch.logsumexp (bound '
            '1e-05)'.format(label, lse_rel))
        if not lse_rel <= 1e-5:
            raise AssertionError('attention lse {}: {:.3e}'.format(label,
                                                                  lse_rel))
        delta = (do.float() * out.float()).sum(-1)
        lib_fwd, lib_fwd_bwd, backend = sdpa_call(q, k, v, do, scale)
        backends.append('{} {}'.format(label, backend))
        r = compare(
            'attention_bwd {} q{} k{} {}'.format(
                label, (b, nq, c), (b, nk, c), str(dtype).split('.')[-1]),
            lambda: cuda_attention.fused_attention_bwd(q, k, v, do, lse, delta,
                                                       scale=scale),
            lambda: cuda_attention.attention_bwd_plain(q, k, v, do, lse, delta,
                                                       scale),
            1e-2 if dtype == torch.bfloat16 else 1e-5, iters, lib_fwd_bwd)
        # SDPA's backward alone: its forward + backward less its forward.
        lib_ms = r['library_ms'] - cuda_ms(lib_fwd, max(iters, 1))
        log('  SDPA backend for {}: {}; its backward {:.4f} ms'.format(
            label, backend, lib_ms))
        total['err'] = max(total['err'], r['err'])
        total['ms'] += calls * r['ms']
        total['plain_ms'] += calls * r['plain_ms']
        total['library_ms'] += calls * lib_ms
        ms, by = least_ms(10 * b * nq * nk * c,
                          nbytes(q, k, v, do, lse, delta) + 4 * (
                              q.numel() + k.numel() + v.numel()),
                          str(dtype).split('.')[-1])
        parts.append((calls * ms, by))
    log('attention_bwd, the 8 calls of one train step: kernel {:.3f} ms, '
        'plain {:.3f} ms, SDPA backward {:.3f} ms'.format(
            total['ms'], total['plain_ms'], total['library_ms']))
    results['attention_bwd'] = add_bound(dict(
        total, tolerance='1e-5 f32, 1e-2 bf16',
        library='F.scaled_dot_product_attention backward ({})'.format(
            ', '.join(backends))), parts)
    return results


def train_reference_check(cfg):
    """Phase 7: one full-width f32 train step (1 clip x 4 boxes, T 32, crop
    224, dropout 0) on the card (kernels) against the same step on the CPU
    (plain versions), from the same params and batch.

    Bounds, relative to the largest CPU value of each tensor: the loss 1e-4;
    each momentum buffer (after one step, lr times the gradient) 1e-3 for
    the FBO, classifier and res5 params and 2e-2 upstream (conv1, res2-res4,
    the backbone's non-local blocks).  Sums in other orders through 101
    layers can flip a near-zero ReLU gate in the backbone, which moves the
    gradients upstream of it (ROADMAP queue 3, "not faults").  A ``*_phi_b``
    buffer is held to the scale of its ``*_phi_w`` buffer: the softmax over
    the keys does not change when every key moves by the same vector, so
    that bias's exact gradient is zero and what both sides hold is rounding.
    """
    import torch
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.train import optimizer
    from lfb_tpu_torch.train.optimizer import get_lr_at_iter
    from lfb_tpu_torch.train.steps import make_train_step, split_params
    spec = build_spec(flagship_cfg({
        **CFG_OVERRIDES, 'TPU.COMPUTE_DTYPE': 'float32',
        'TRAIN.DROPOUT_RATE': 0.0, 'FBO_NL.DROPOUT_RATE': 0.0}), 'train')
    params = perturbed_params(spec, torch.device('cuda'))
    batch = make_batch(spec, np.random.default_rng(SEED + 5), 'cuda',
                       n_clips=1, with_lfb=True, with_labels=True)
    lr = get_lr_at_iter(cfg.SOLVER, 0)
    runs = {}
    for device in ('cuda', 'cpu'):
        p = {k: v.to(device, copy=True) for k, v in params.items()}
        trainable, frozen = split_params(spec, p)
        state = optimizer.init_state(p, set(frozen))
        t0 = time.perf_counter()
        _, _, state, aux = make_train_step(spec, cfg.SOLVER)(
            trainable, frozen, state,
            {k: v.to(device) for k, v in batch.items()},
            torch.Generator(device=device).manual_seed(SEED), lr)
        loss = aux['loss'].item()
        runs[device] = (loss, {k: v.cpu() for k, v in state.momentum.items()},
                        time.perf_counter() - t0)
    (gpu_loss, gpu_m, gpu_s), (cpu_loss, cpu_m, cpu_s) = runs['cuda'], runs['cpu']
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    log('train reference: loss card {:.7f} CPU {:.7f}, rel {:.3e} (bound '
        '1e-04); card {:.1f} s (first step), CPU {:.1f} s'.format(
            gpu_loss, cpu_loss, loss_rel, gpu_s, cpu_s))
    worst = {True: (0.0, ''), False: (0.0, '')}
    for name, ref in cpu_m.items():
        got = gpu_m[name]
        if not torch.isfinite(got).all():
            raise AssertionError('train reference: non-finite ' + name)
        scale = ref.abs().max().item()
        if name.endswith('_phi_b'):
            scale = max(scale, cpu_m[name[:-1] + 'w'].abs().max().item())
        rel = ((got - ref).abs().max() / max(scale, 1e-30)).item()
        # Downstream of the backbone's ReLU gates: FBO, classifier, res5.
        group = (name.startswith(('pred_', 'lfb_', 'res5_'))
                 or '_fbonl_reduc' in name)
        worst[group] = max(worst[group], (rel, name))
    bounds = {True: 1e-3, False: 2e-2}
    for group, label in ((True, 'FBO, classifier, res5'),
                         (False, 'conv1, res2-res4, non-local')):
        rel, name = worst[group]
        log('train reference momentum, {}: worst rel err {:.3e} ({}; bound '
            '{:.0e})'.format(label, rel, name, bounds[group]))
    if not (loss_rel <= 1e-4 and worst[True][0] <= bounds[True]
            and worst[False][0] <= bounds[False]):
        raise AssertionError('train reference check failed')


def train_phase(cfg, bank):
    """Phase 8: the flagship train step at B = 8 clips x 4 boxes with the
    AVA-scale device bank; returns the launch counts of its steps."""
    import torch
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.train import optimizer
    from lfb_tpu_torch.train.optimizer import get_lr_at_iter
    from lfb_tpu_torch.train.steps import make_train_step, split_params
    dev = torch.device('cuda')
    spec = build_spec(cfg, 'train')
    log('train spec: crop {}, T {}, dropout {} / FBO {}, {}'.format(
        spec.crop_size, spec.video_length, spec.dropout_rate,
        spec.fbo.dropout_rate, spec.compute_dtype))
    params = perturbed_params(spec, dev)
    trainable, frozen = split_params(spec, params)
    state = optimizer.init_state(params, set(frozen))
    step = make_train_step(spec, cfg.SOLVER, bank=bank)
    rng = np.random.default_rng(SEED + 6)
    batches = [make_batch(spec, rng, dev, n_clips=TRAIN_B, with_labels=True)
               for _ in range(TRAIN_WARMUP + TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    stamps, losses = [], []
    for i, batch in enumerate(timed(batches, stamps)):
        before = read_launches()
        trainable, frozen, state, aux = step(
            trainable, frozen, state, batch,
            torch.Generator(device=dev).manual_seed(SEED + i),
            get_lr_at_iter(cfg.SOLVER, i))
        after = read_launches()
        per_step = {k: after[k] - before[k] for k in after}
        if per_step != PER_FORWARD['train']:
            raise AssertionError('train step {}: launches {} != {}'.format(
                i, per_step, PER_FORWARD['train']))
        losses.append(aux['loss'].item())
        prob = aux['prob']
        if not np.isfinite(losses[-1]) or tuple(prob.shape) != (
                TRAIN_B * BOXES_PER_CLIP, spec.num_classes):
            raise AssertionError('train step {}: loss {} prob {}'.format(
                i, losses[-1], tuple(prob.shape)))
        for name in ('conv1_w', 'pred_w', 'lfb_nl2_out_w'):
            if not state.momentum[name].any():
                raise AssertionError('train step {}: zero momentum for '
                                     '{}'.format(i, name))
    launches = read_launches()
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    steady = statistics.mean(ms[TRAIN_WARMUP:])
    log('train: launches per step {}; losses {}'.format(
        PER_FORWARD['train'], ['{:.5f}'.format(x) for x in losses]))
    log('train: ms per step {}; {:.1f} ms per step over the {} timed steps, '
        '{:.2f} clips/s; peak device memory {:.2f} GiB'.format(
            ['{:.1f}'.format(m) for m in ms], steady, TRAIN_STEPS,
            TRAIN_B / (steady / 1e3),
            torch.cuda.max_memory_allocated() / 2 ** 30))
    return launches


def trace_window(label, run, count, out, stem):
    """Run ``run(i)`` for i < ``count`` on the host clock, then the same
    under torch.profiler; write the Chrome trace and the operator table to
    ``out`` and print, from the traced window alone, device time per kernel
    and the device's idle share: 1 - (union of the card's kernel, copy and
    memset intervals) / (the window on the host clock, from the first
    launch to the card's last work)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    stamps = []
    for i in timed(range(count), stamps):
        run(i)
    plain_ms = (stamps[-1] - stamps[0]) * 1e3 / count
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function('traced_window'):
            for i in range(count):
                run(i)
            torch.cuda.synchronize()
    trace_path = out / '{}_trace.json'.format(stem)
    prof.export_chrome_trace(str(trace_path))
    (out / '{}_ops.txt'.format(stem)).write_text(prof.key_averages().table(
        sort_by='self_cuda_time_total', row_limit=60))
    events = [e for e in json.loads(trace_path.read_text())['traceEvents']
              if e.get('ph') == 'X']
    window = next(e for e in events if e['name'] == 'traced_window'
                  and e.get('cat') == 'user_annotation')
    t0, t1 = window['ts'], window['ts'] + window['dur']
    device = [e for e in events
              if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')
              and t0 <= e['ts'] <= t1]
    busy = busy_us([(e['ts'], e['ts'] + e['dur']) for e in device], t0, t1)
    per_name = {}
    for e in device:
        per_name[e['name']] = per_name.get(e['name'], 0.0) + e['dur']
    log('profile, {}: untraced {:.1f} ms each; traced window {:.1f} ms each, '
        'device busy {:.1f} ms each, idle share {:.4f}'.format(
            label, plain_ms, (t1 - t0) / 1e3 / count, busy / 1e3 / count,
            1 - busy / (t1 - t0)))
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:15]:
        log('  {:8.3f} ms each {:5.1f}%  {}'.format(
            us / 1e3 / count, 100 * us / busy, name[:100]))
    log('wrote {} and {}'.format(trace_path, out / '{}_ops.txt'.format(stem)))


def profile(cfg, out_dir, forwards=3):
    """``--profile DIR``: the full-width phase-B forward (two warm-ups, then
    ``forwards`` batches), one such forward with the fused bottleneck (two
    warm-ups first) and then the train step at B = 8 (two warm-ups, then one
    step) with the same device bank, each through :func:`trace_window`."""
    import pathlib
    import torch
    from lfb_tpu_torch.bank.device_bank import build_device_bank
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.train import optimizer
    from lfb_tpu_torch.train.optimizer import get_lr_at_iter
    from lfb_tpu_torch.train.steps import (make_eval_step, make_train_step,
                                           split_params)
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    dev = torch.device('cuda')
    spec_b = build_spec(cfg, 'test')
    params = perturbed_params(spec_b, dev)
    rng = np.random.default_rng(SEED + 3)
    bank = build_device_bank(cfg, synthetic_host_bank({}, rng), device=dev)
    infer = make_eval_step(spec_b, bank=bank, bank_seed=SEED)
    batches = [make_batch(spec_b, rng, dev) for _ in range(forwards)]
    for batch in batches[:2]:
        infer(params, batch)
    trace_window('phase B at B = {}'.format(B),
                 lambda i: infer(params, batches[i]), forwards, out, 'phase_b')
    infer = make_eval_step(
        build_spec(flagship_cfg({**CFG_OVERRIDES, **FUSED}), 'test'),
        bank=bank, bank_seed=SEED)
    for batch in batches[:2]:
        infer(params, batch)
    trace_window('phase B at B = {}, fused bottleneck'.format(B),
                 lambda i: infer(params, batches[2 + i]), 1, out,
                 'phase_b_fused')
    del params, batches

    spec = build_spec(cfg, 'train')
    params = perturbed_params(spec, dev)
    trainable, frozen = split_params(spec, params)
    state = optimizer.init_state(params, set(frozen))
    step = make_train_step(spec, cfg.SOLVER, bank=bank)
    batches = [make_batch(spec, rng, dev, n_clips=TRAIN_B, with_labels=True)
               for _ in range(3)]

    def train(i):
        step(trainable, frozen, state, batches[i],
             torch.Generator(device=dev).manual_seed(SEED + i),
             get_lr_at_iter(cfg.SOLVER, i))

    for i in range(2):
        train(i)
    trace_window('train step at B = {}'.format(TRAIN_B),
                 lambda i: train(2 + i), 1, out, 'train_step')


def main():
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument(
        '--profile', metavar='DIR',
        help='instead of the checks, trace the full-width phase-B forward and '
             'a train step and write the traces and operator tables to DIR')
    args = parser.parse_args()
    preamble()
    import torch
    from lfb_tpu_torch.config import flagship_cfg
    cfg = flagship_cfg(CFG_OVERRIDES)
    if args.profile:
        profile(cfg, args.profile)
        return
    results = check_kernels()
    reference_check(cfg)
    launches, bank = main_path(cfg)
    charades_launches = charades_path()
    results.update(check_backward_kernels())
    train_reference_check(cfg)
    train_launches = train_phase(cfg, bank)
    kernels = []
    for name, meta in KERNELS.items():
        r = results[name]
        kernels.append({'name': name, **meta,
                        'launches': (launches[name] + charades_launches[name]
                                     + train_launches[name]),
                        'max_abs_err': r['err'], 'ms': r['ms'],
                        'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                        'bound_by': r['bound_by'],
                        'library_ms': r['library_ms'],
                        'library': r.get('library'),
                        'tolerance': r['tolerance']})
    print(card_line())
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()

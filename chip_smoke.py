#!/usr/bin/env python3
"""Drive the lfb_tpu_torch port once on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; without a CUDA device, or
away from the rest of the repository, it exits non-zero before printing any
result):

1. Print the card's name and power limit, build the CUDA kernels of
   ``lfb_tpu_torch/csrc`` and print the build time.
2. Hold each kernel against its plain PyTorch version on the card, at the
   flagship shapes (every attention regime), and time both (median of
   CUDA-event timings, taken in turns).
3. Hold the full-width model on the card (f32, kernels) against the same
   model on the CPU (f32, plain versions) on one clip.
4. The main path at full width: ``flagship_cfg()`` (R101-I3D-NL, 3-layer
   FBO-NL, 300-row windows, T 32, crop 256), 16 clips x 4 boxes per batch,
   seeded perturbed weights, uint8 frames.  Phase A runs the bank
   extraction entry point (``extract_ava_bank``) over 2 batches, which
   returns the host bank; synthetic rows top it up to AVA scale (235 videos
   x 897 s, Poisson(2) rows per second); the bank goes to the card.  Phase B
   runs 3 batches of the eval step with that bank.  Each kernel's launch counter is reset before the phase and must
   read exactly its launches per forward times the batches after it.

TF32 is off for matmuls and cuDNN convolutions throughout, so the plain
versions the kernels are compared with compute in full f32.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile DIR`` runs none of the checks: it traces
the full-width phase-B forward with torch.profiler and writes the trace and
the operator table to DIR (see :func:`profile_phase_b`).
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
AVA_VIDEOS = 235
TIMING_ITERS = 10

KERNELS = {
    'stem_conv': dict(route='cuda', source='lfb_tpu_torch/csrc/stem_conv.cu',
                      replaces='lfb_tpu/ops/pallas_stem.py:212'),
    'roi_align_maxpool': dict(
        route='cuda', source='lfb_tpu_torch/csrc/roi_align_maxpool.cu',
        replaces='lfb_tpu/ops/pallas_roi_align.py:186'),
    'attention': dict(route='cuda', source='lfb_tpu_torch/csrc/attention.cu',
                      replaces='lfb_tpu/ops/pallas_attention.py:111'),
}
# Kernel launches per forward of each phase.
PER_FORWARD = {'A': {'stem_conv': 1, 'roi_align_maxpool': 1, 'attention': 5},
               'B': {'stem_conv': 1, 'roi_align_maxpool': 1, 'attention': 8}}


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


def compare(label, kernel_fn, plain_fn, bound, iters):
    """Kernel vs plain on the same inputs; returns (max_abs_err, ms,
    plain_ms).  ``bound`` is relative to max |plain|."""
    import torch
    got = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError('{}: shape {} vs {} or non-finite output'.format(
            label, tuple(got.shape), tuple(ref.shape)))
    err = (got - ref).abs().max().item()
    scale = max(ref.abs().max().item(), 1e-30)
    ms, plain_ms = [], []
    for _ in range(max(iters, 1)):   # in turns: kernel, plain
        ms.append(cuda_ms(kernel_fn, 1))
        plain_ms.append(cuda_ms(plain_fn, 1))
    ms, plain_ms = statistics.median(ms), statistics.median(plain_ms)
    log('{}: max_abs_err {:.3e}, rel {:.3e} (bound {:.0e}); kernel {:.4f} ms, '
        'plain {:.4f} ms'.format(label, err, err / scale, bound, ms, plain_ms))
    if not err <= bound * scale:
        raise AssertionError('{}: error {:.3e} above {:.0e} x max|ref| '
                             '{:.3e}'.format(label, err, bound, scale))
    return err, ms, plain_ms


def rand_rois(rng, n_clips, boxes, crop):
    n = n_clips * boxes
    return np.stack([
        np.repeat(np.arange(n_clips), boxes).astype(np.float32),
        rng.uniform(0, crop / 2, n), rng.uniform(0, crop / 2, n),
        rng.uniform(crop / 2, crop, n), rng.uniform(crop / 2, crop, n)],
        axis=1).astype(np.float32)


def check_kernels(iters=TIMING_ITERS):
    """Phase 2: each kernel vs its plain version at the flagship shapes.

    Bounds, relative to max |plain|: bf16 outputs 1e-2 (both sides round an
    f32 accumulation to bf16, 2^-8 apart at most twice over); f32 outputs
    1e-5 (f32 sums of at most a few thousand terms in another order).
    """
    import torch
    from lfb_tpu_torch.ops import cuda_attention, cuda_roi_align, cuda_stem
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    results = {}

    x = torch.randint(0, 256, (B, 32, 256, 256, 3), generator=g, device=dev)
    x = ((x.float() / 255 - 0.45) / 0.225).to(torch.bfloat16)
    w = torch.randn((64, 3, 5, 7, 7), generator=g, device=dev) * (2 / 735) ** .5
    results['stem_conv'] = compare(
        'stem_conv x{} bf16'.format(tuple(x.shape)),
        lambda: cuda_stem.stem_conv(x, w, temporal_pad=2),
        lambda: cuda_stem.stem_conv_plain(x, w, 2), 1e-2, iters)
    del x

    fmap = torch.relu(torch.randn((B, 16, 16, 2048), generator=g, device=dev))
    rois = torch.from_numpy(rand_rois(rng, B, BOXES_PER_CLIP, 256)).to(dev)
    results['roi_align_maxpool'] = compare(
        'roi_align_maxpool fmap{} rois{} f32'.format(tuple(fmap.shape),
                                                     tuple(rois.shape)),
        lambda: cuda_roi_align.roi_align_maxpool(fmap, rois),
        lambda: cuda_roi_align.roi_align_maxpool_plain(fmap, rois), 1e-5, iters)

    # (label, B, Nq, Nk, C, dtype, calls per phase-B forward)
    regimes = [('res3 NL', 64, 4096, 1024, 256, torch.bfloat16, 2),
               ('res4 NL', 16, 4096, 1024, 512, torch.bfloat16, 3),
               ('FBO-NL', 64, 1, 300, 512, torch.float32, 3)]
    err, ms, plain_ms = 0.0, 0.0, 0.0
    for label, b, nq, nk, c, dtype, calls in regimes:
        q, k, v = (torch.randn((b, n, c), generator=g, device=dev).to(dtype)
                   for n in (nq, nk, nk))
        e, m, pm = compare(
            'attention {} q{} k{} {}'.format(label, (b, nq, c), (b, nk, c),
                                            str(dtype).split('.')[-1]),
            lambda: cuda_attention.fused_attention(q, k, v, scale=c ** -0.5),
            lambda: cuda_attention.attention_plain(q, k, v, c ** -0.5),
            1e-2 if dtype == torch.bfloat16 else 1e-5, iters)
        err, ms, plain_ms = max(err, e), ms + calls * m, plain_ms + calls * pm
    log('attention, the 8 calls of one phase-B forward: kernel {:.3f} ms, '
        'plain {:.3f} ms'.format(ms, plain_ms))
    results['attention'] = (err, ms, plain_ms)
    return results


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


def make_batch(spec, rng, device, *, n_clips=B, boxes=BOXES_PER_CLIP,
               with_lfb=False):
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
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def reference_check(cfg):
    """Phase 3: full width, one clip, f32: kernels on the card vs plain
    versions on the CPU.  Bound 2e-3 x max|CPU| (f32 sums through 101
    layers, taken in other orders by cuDNN, the kernels and the CPU)."""
    import torch
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.model import forward
    from lfb_tpu_torch.models.spec import build_spec
    spec = build_spec(flagship_cfg({'NUM_GPUS': 1,
                                    'TPU.COMPUTE_DTYPE': 'float32'}), 'test')
    params = perturbed_params(spec, torch.device('cuda'))
    batch = make_batch(spec, np.random.default_rng(SEED + 1), 'cuda',
                       n_clips=1, boxes=2, with_lfb=True)
    t0 = time.perf_counter()
    gpu = forward(spec, params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu = forward(spec, {k: v.cpu() for k, v in params.items()},
                  {k: v.cpu() for k, v in batch.items()})
    t2 = time.perf_counter()
    for key in ('box_pooled', 'logits', 'prob'):
        got, ref = gpu[key].float().cpu(), cpu[key].float()
        err = (got - ref).abs().max().item()
        scale = max(ref.abs().max().item(), 1e-30)
        log('reference {}: card vs CPU max_abs_err {:.3e}, rel {:.3e} (bound '
            '2e-03)'.format(key, err, err / scale))
        if not (torch.isfinite(got).all() and err <= 2e-3 * scale):
            raise AssertionError('reference check failed for ' + key)
    log('reference forward: card {:.1f} s (first call), CPU {:.1f} s'.format(
        t1 - t0, t2 - t1))


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


def run_phase(label, fn, batches, per_forward):
    """Call ``fn`` on the batches (through :func:`timed`) with every launch
    counter at 0 just before and read just after; check the counters.
    Returns (ms per batch after the first, fn's result, launches)."""
    from lfb_tpu_torch.ops import cuda_attention, cuda_roi_align, cuda_stem
    modules = {'stem_conv': cuda_stem, 'roi_align_maxpool': cuda_roi_align,
               'attention': cuda_attention}
    stamps = []
    for mod in modules.values():
        mod.LAUNCHES = 0
    result = fn(timed(batches, stamps))
    launches = {name: mod.LAUNCHES for name, mod in modules.items()}
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
    """Phase 4: bank extraction, the AVA-scale bank, FBO inference."""
    import torch
    from lfb_tpu_torch.bank.device_bank import build_device_bank
    from lfb_tpu_torch.bank.lfb import extract_ava_bank
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


def profile_phase_b(cfg, out_dir, forwards=3):
    """``--profile DIR``: the phase-B forward at full width under
    torch.profiler.  Two warm-ups, then ``forwards`` batches untimed by the
    profiler (host clock), then the same batches traced.  Writes the Chrome
    trace and the operator table to DIR, and prints, from the traced window
    alone, device time per kernel and the device's idle share: 1 - (union of
    the card's kernel, copy and memset intervals) / (the window on the host
    clock, from the first forward's launch to the card's last work)."""
    import pathlib
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from lfb_tpu_torch.bank.device_bank import build_device_bank
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.train.steps import make_eval_step
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
    stamps = []
    for batch in timed(batches, stamps):
        infer(params, batch)
    plain_ms = (stamps[-1] - stamps[0]) * 1e3 / forwards
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function('traced_window'):
            for batch in batches:
                infer(params, batch)
            torch.cuda.synchronize()
    trace_path = out / 'phase_b_trace.json'
    prof.export_chrome_trace(str(trace_path))
    (out / 'phase_b_ops.txt').write_text(prof.key_averages().table(
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
    log('profile, phase B at B = {}: untraced {:.1f} ms per forward; traced '
        'window {:.1f} ms per forward, device busy {:.1f} ms per forward, '
        'idle share {:.4f}'.format(B, plain_ms, (t1 - t0) / 1e3 / forwards,
                                   busy / 1e3 / forwards, 1 - busy / (t1 - t0)))
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:15]:
        log('  {:8.3f} ms per forward {:5.1f}%  {}'.format(
            us / 1e3 / forwards, 100 * us / busy, name[:100]))
    log('wrote {} and {}'.format(trace_path, out / 'phase_b_ops.txt'))


def main():
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument(
        '--profile', metavar='DIR',
        help='instead of the checks, trace the full-width phase-B forward '
             'and write the trace and operator table to DIR')
    args = parser.parse_args()
    preamble()
    import torch
    from lfb_tpu_torch.config import flagship_cfg
    if args.profile:
        profile_phase_b(flagship_cfg({'NUM_GPUS': 1}), args.profile)
        return
    results = check_kernels()
    cfg = flagship_cfg({'NUM_GPUS': 1})
    reference_check(cfg)
    launches = main_path(cfg)
    kernels = []
    for name, meta in KERNELS.items():
        err, ms, plain_ms = results[name]
        kernels.append({'name': name, **meta, 'launches': launches[name],
                        'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms})
    print(card_line())
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()

"""Per-op FLOP and utilization probe of the flagship forward on the card
(port of ``tools/mfu_probe.py``, mode for mode).

  grid -- the train-mode forward with its loss over the (batch, crop) grid:
          ms, TF (:func:`lfb_tpu_torch.utils.flops.cost_analysis`), TFLOP/s
          and MFU.
  conv -- records every conv3d / conv1x1 / attention signature of that
          forward (and the stem) by patching ``models.backbone``'s symbols,
          checks each signature's FLOP model against ``FlopCounterMode``'s
          count of that one op, times each alone on the card in bf16 at
          three shape regimes and prints the per-op table by train-shape
          time, with the sum of the isolated times beside the whole
          forward's.  A row above the card's peak is marked INVALID in the
          table, with the reason, and left out of the aggregates.
  flat -- kTx1x1 convs (cuDNN, channels-last) against the same convs as
          ``torch.matmul`` over (B*T*H*W, Cin), one matmul per tap.

Usage:  python -m lfb_tpu_torch.tools.mfu_probe [grid|conv|flat|all]

Every mode runs on a CUDA device and raises without one.  MFU is against
the H100's dense bf16 peak; each table is headed by the card's name and
power limit, since a card set below 700 W runs slower under load.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

# NVIDIA H100 SXM, dense bf16 (the tensor cores' peak, at 700 W).
PEAK_FLOPS = 989e12
GRID = [(8, 224), (16, 224), (8, 256), (16, 256)]
REGIMES = [(8, 224), (8, 256), (16, 256)]
TRAIN_REGIME = (8, 224)
GRID_ITERS = 20
SIG_ITERS = 30
WARMUP = 2


def _require_card(mode: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError('mfu_probe {}: runs on a CUDA device; none is '
                           'available'.format(mode))


def card_line() -> str:
    """``name, power.limit`` of the card, as nvidia-smi prints them."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _flagship(train_crop: int, train_batch: int):
    """(cfg, train spec): ``flagship_cfg`` at T 32, the crop and the batch,
    ``TPU.REMAT ''`` (as ``tools/mfu_probe.py:_flagship``), on one card."""
    from lfb_tpu_torch.config import flagship_cfg
    from lfb_tpu_torch.models.spec import build_spec
    cfg = flagship_cfg({'TRAIN.VIDEO_LENGTH': 32,
                        'TRAIN.CROP_SIZE': train_crop,
                        'TRAIN.BATCH_SIZE': train_batch, 'TPU.REMAT': '',
                        'NUM_GPUS': 1})
    return cfg, build_spec(cfg, 'train')


def _train_batch(spec, B: int, crop: int, boxes_per_clip: int = 4,
                 device='cuda') -> Dict[str, torch.Tensor]:
    """The probe's batch (the keys and draws of ``tools/mfu_probe.py``),
    on ``device``."""
    rng = np.random.RandomState(0)
    n = B * boxes_per_clip
    blobs = {
        'data': 0.1 * rng.randn(B, spec.video_length, crop, crop, 3),
        'labels': (rng.rand(n, 80) > 0.95),
        'proposals': np.stack([np.repeat(np.arange(B), boxes_per_clip)]
                              + [rng.uniform(0, crop, n) for _ in range(4)],
                              1),
        'box_mask': np.ones(n),
        'lfb': rng.randn(n, spec.fbo.num_lfb_feat, 2048)}
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in blobs.items()}


def _loss_fn(spec) -> Callable:
    """(params, batch) -> the train-mode forward's loss, on one model."""
    from lfb_tpu_torch.models.model import LFBModel
    from lfb_tpu_torch.train.steps import loss
    model = LFBModel(spec)

    def fwd_loss(params, batch):
        generator = torch.Generator(batch['data'].device).manual_seed(0)
        logits = model.run(params, batch, train=True,
                           generator=generator)['logits']
        return loss(spec, logits, batch['labels'], batch['box_mask'])
    return fwd_loss


def _timed(fn: Callable, args, iters: int, warmup: int = WARMUP) -> float:
    """Seconds per call of ``fn(*args)``: CUDA events around ``iters``
    calls back to back, after ``warmup`` calls."""
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


# ---------------------------------------------------------------- grid

def grid_row(B: int, crop: int) -> Dict[str, float]:
    """The train-mode forward with its loss at (B, crop), no gradients:
    ms per call, TF per call and the rate."""
    from lfb_tpu_torch.models.model import init_params
    from lfb_tpu_torch.utils.flops import cost_analysis
    _, spec = _flagship(crop, B)
    params = init_params(spec, torch.Generator('cuda').manual_seed(0))
    batch = _train_batch(spec, B, crop)
    fwd_loss = _loss_fn(spec)
    with torch.no_grad():
        tf = cost_analysis(fwd_loss, params, batch)['flops'] / 1e12
        dt = _timed(fwd_loss, (params, batch), GRID_ITERS)
    del params, batch
    torch.cuda.empty_cache()
    return {'B': B, 'crop': crop, 'ms': dt * 1e3, 'tf': tf,
            'tflops': tf / dt, 'mfu': tf / dt * 1e12 / PEAK_FLOPS}


def run_grid(grid=GRID) -> Dict[Tuple[int, int], Dict[str, float]]:
    _require_card('grid')
    print('# Whole-forward loss over the (batch, crop) grid, bf16; card: '
          + card_line())
    print('| B | crop | ms | TF | TFLOP/s | MFU |')
    print('|---|---|---|---|---|---|', flush=True)
    rows = {}
    for B, crop in grid:
        row = rows[(B, crop)] = grid_row(B, crop)
        print('| {B} | {crop} | {ms:.2f} | {tf:.3f} | {tflops:.1f} | '
              '{mfu:.1%} |'.format(**row), flush=True)
    return rows


# ---------------------------------------------------------------- conv

@dataclasses.dataclass(frozen=True)
class ConvSig:
    """One op call of the backbone.  ``kind`` is 'conv3d', 'conv1x1',
    'attention' (``x_shape`` the queries, ``w_shape`` the keys) or 'stem'
    (conv1, the hand kernel).  Activations are NDHWC; weights are in the
    port's layout, (Cout, Cin/groups, kT, kH, kW), or (Cout, Cin) for a
    conv1x1."""
    kind: str
    x_shape: Tuple[int, ...]
    w_shape: Tuple[int, ...]
    strides: Tuple[int, ...] = (1, 1, 1)
    dilation: Tuple[int, ...] = (1, 1, 1)
    groups: int = 1
    padding: Tuple[int, ...] = (0, 0, 0)

    def out_shape(self) -> Tuple[int, ...]:
        """(B, T', H', W', Cout) of a conv3d or stem."""
        B, *dims, _ = self.x_shape
        out = [(n + 2 * p - d * (k - 1) - 1) // s + 1 for n, k, s, p, d in zip(
            dims, self.w_shape[2:], self.strides, self.padding,
            self.dilation)]
        return (B, *out, self.w_shape[0])

    def flops(self) -> float:
        if self.kind == 'attention':
            B, L, d = self.x_shape
            return 2.0 * B * L * self.w_shape[1] * d * 2    # q k^T and p v
        if self.kind == 'conv1x1':
            cout, cin = self.w_shape[:2]
            return 2.0 * float(np.prod(self.x_shape[:-1])) * cin * cout
        cout, cin_g, kt, kh, kw = self.w_shape
        out = self.out_shape()
        return 2.0 * float(np.prod(out[:-1])) * cout * cin_g * kt * kh * kw

    def label(self) -> str:
        if self.kind == 'attention':
            return 'attn B{} L{} Lkv{} d{}'.format(
                self.x_shape[0], self.x_shape[1], self.w_shape[1],
                self.x_shape[2])
        if self.kind == 'conv1x1':
            return '1x1 {}->{} @{}'.format(
                self.w_shape[1], self.w_shape[0],
                'x'.join(map(str, self.x_shape[:-1])))
        cout, cin_g, kt, kh, kw = self.w_shape
        tag = '{}{}x{}x{} {}->{}'.format('stem ' if self.kind == 'stem'
                                         else '', kt, kh, kw,
                                         cin_g * self.groups, cout)
        if self.strides != (1, 1, 1):
            tag += ' s{}'.format(max(self.strides))
        if self.dilation != (1, 1, 1):
            tag += ' d{}'.format(max(self.dilation))
        return tag + ' @{}'.format('x'.join(map(str, self.x_shape[:-1])))


def collect_sigs(spec, B: int, crop: int) -> Dict[ConvSig, int]:
    """{signature: calls} of the train-mode forward at (B, crop), traced on
    fake CPU tensors (no card, no memory) with recorders patched over
    ``models.backbone``'s ``conv3d``, ``conv1x1``,
    ``scaled_softmax_attention`` and ``StemConv``; the symbols are restored
    in a ``finally``.  As in ``lfb_tpu``, the FBO and the head import their
    own ops and are not recorded."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from lfb_tpu_torch.models import backbone as bb
    from lfb_tpu_torch.models.model import init_params

    sigs: Dict[ConvSig, int] = {}

    def record(sig):
        sigs[sig] = sigs.get(sig, 0) + 1

    real = bb.conv3d, bb.conv1x1, bb.scaled_softmax_attention, bb.StemConv

    def rec_conv3d(x, w, *, strides=(1, 1, 1), padding=(0, 0, 0),
                   dilation=(1, 1, 1), groups=1, bias=None):
        record(ConvSig('conv3d', tuple(x.shape), tuple(w.shape),
                       tuple(strides), tuple(dilation), groups,
                       tuple(padding)))
        return real[0](x, w, strides=strides, padding=padding,
                       dilation=dilation, groups=groups, bias=bias)

    def rec_conv1x1(x, w, bias=None):
        record(ConvSig('conv1x1', tuple(x.shape), tuple(w.shape[:2])))
        return real[1](x, w, bias)

    def rec_attn(q, k, v, **kw):
        record(ConvSig('attention', tuple(q.shape), tuple(k.shape)))
        return real[2](q, k, v, **kw)

    class RecStem:
        @staticmethod
        def apply(x, w, temporal_pad):
            record(ConvSig('stem', tuple(x.shape), tuple(w.shape), (1, 2, 2),
                           padding=(temporal_pad, 3, 3)))
            return real[3].apply(x, w, temporal_pad)

    bb.conv3d, bb.conv1x1 = rec_conv3d, rec_conv1x1
    bb.scaled_softmax_attention, bb.StemConv = rec_attn, RecStem
    try:
        with FakeTensorMode():
            params = init_params(spec, torch.Generator().manual_seed(0))
            n = B * 4
            batch = {'data': torch.empty(B, spec.video_length, crop, crop,
                                         3),
                     'labels': torch.empty(n, 80),
                     'proposals': torch.empty(n, 5),
                     'box_mask': torch.empty(n),
                     'lfb': torch.empty(n, spec.fbo.num_lfb_feat, 2048)}
            with torch.no_grad():
                _loss_fn(spec)(params, batch)
    finally:
        (bb.conv3d, bb.conv1x1, bb.scaled_softmax_attention,
         bb.StemConv) = real
    return sigs


def sig_op(sig: ConvSig, device, dtype=torch.bfloat16):
    """(fn, args): the op of ``sig`` as the forward runs it (attention
    through ``FusedAttention``, the stem through its kernel's wrapper,
    convs through ``ops.conv3d``), on seeded inputs of its shapes."""
    from lfb_tpu_torch.ops.conv3d import conv1x1, conv3d
    from lfb_tpu_torch.ops.cuda_attention import FusedAttention
    from lfb_tpu_torch.ops.cuda_stem import stem_conv
    g = torch.Generator(device).manual_seed(0)
    x = torch.randn(sig.x_shape, generator=g, device=device, dtype=dtype)
    w = torch.randn(sig.w_shape, generator=g, device=device,
                    dtype=dtype) * 0.05
    if sig.kind == 'attention':
        v = torch.randn(sig.w_shape, generator=g, device=device, dtype=dtype)
        scale = sig.x_shape[-1] ** -0.5
        return (lambda q, k, v: FusedAttention.apply(q, k, v, scale)), (
            x, w, v)
    if sig.kind == 'conv1x1':
        return conv1x1, (x, w)
    if sig.kind == 'stem':
        return (lambda x, w: stem_conv(x, w, temporal_pad=sig.padding[0])), (
            x, w)
    return (lambda x, w: conv3d(x, w, strides=sig.strides, padding=sig.padding,
                                dilation=sig.dilation, groups=sig.groups)), (
        x, w)


def counted_flops(sig: ConvSig) -> float:
    """``FlopCounterMode``'s count of ``sig``'s op at its real shapes, on
    fake CPU tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from lfb_tpu_torch.utils.flops import cost_analysis
    with FakeTensorMode():
        fn, args = sig_op(sig, 'cpu')
    return cost_analysis(fn, *args)['flops']


def bench_sig(sig: ConvSig, iters: int = SIG_ITERS) -> float:
    """Seconds per call of ``sig``'s op alone on the card, bf16."""
    _require_card('conv')
    fn, args = sig_op(sig, 'cuda')
    with torch.no_grad():
        return _timed(fn, args, iters)


def _struct_key(sig: ConvSig):
    """The layer a signature belongs to, the same at every regime."""
    if sig.kind in ('conv3d', 'stem'):
        return (sig.kind, sig.w_shape, sig.strides, sig.dilation, sig.groups,
                sig.x_shape[1])     # T tells res2 from res3+
    if sig.kind == 'conv1x1':
        return ('conv1x1', sig.w_shape, sig.x_shape[1])
    return ('attention', sig.x_shape[-1], sig.x_shape[1])


def run_conv(forward: Dict[Tuple[int, int], Dict[str, float]] | None = None
             ) -> List[Dict]:
    """The per-op table.  ``forward``: ``run_grid``'s rows for the regimes
    (each is timed here where missing).  Returns one entry per (layer,
    regime): its signature, calls, ms, MFU and whether it is INVALID."""
    _require_card('conv')
    forward = dict(forward or {})
    tables = {}
    for B, crop in REGIMES:
        _, spec = _flagship(crop, B)
        tables[(B, crop)] = sigs = collect_sigs(spec, B, crop)
        print('# regime B={} crop={}: {} op calls, {} unique signatures'
              .format(B, crop, sum(sigs.values()), len(sigs)), flush=True)
        if (B, crop) not in forward:
            forward[(B, crop)] = grid_row(B, crop)

    entries = []
    for reg, sigs in tables.items():
        for sig, count in sorted(sigs.items(), key=lambda kv: -kv[0].flops()):
            counted = counted_flops(sig)
            if counted != sig.flops():
                raise AssertionError('mfu_probe: {} models {:.6g} FLOPs, '
                                     'FlopCounterMode counts {:.6g}'.format(
                                         sig.label(), sig.flops(), counted))
            entries.append(conv_entry(sig, reg, count, bench_sig(sig)))
    print('# Per-op, each signature alone, bf16, {} calls after a warm-up; '
          'card: {}'.format(SIG_ITERS, card_line()))
    for line in conv_table(entries, forward):
        print(line)
    print(flush=True)
    return entries


def conv_entry(sig: ConvSig, regime: Tuple[int, int], count: int,
               seconds: float) -> Dict:
    """One (signature, regime) row of the per-op table: a call of ``sig``
    took ``seconds`` alone.  Above the card's peak it is INVALID."""
    mfu = sig.flops() / seconds / PEAK_FLOPS
    return {'sig': sig, 'regime': regime, 'count': count,
            'ms': seconds * 1e3, 'total_ms': seconds * 1e3 * count,
            'mfu': mfu, 'invalid': mfu > 1.0}


def conv_table(entries: List[Dict],
               forward: Dict[Tuple[int, int], Dict[str, float]]) -> List[str]:
    """The per-op table's lines, one row per layer by train-shape time, then
    each regime's aggregate: the isolated ops' ms, TF and MFU over the
    entries that are not INVALID, beside the whole forward's
    (``forward[regime]``, a ``grid_row``)."""
    rows: Dict[Tuple, Dict] = {}
    for e in entries:
        rows.setdefault(_struct_key(e['sig']), {})[e['regime']] = e
    lines = ['| op (train shape) | n | train ms (sum) | MFU@8/224 | '
             'MFU@8/256 | MFU@16/256 | note |',
             '|---|---|---|---|---|---|---|']
    for row in sorted(rows.values(), key=lambda r: -r.get(
            TRAIN_REGIME, {}).get('total_ms', 0.0)):
        tr = row.get(TRAIN_REGIME)
        cell = lambda reg: ('-' if reg not in row else '{:.1%}{}'.format(
            row[reg]['mfu'], ' INVALID' if row[reg]['invalid'] else ''))
        bad = ['{}/{}'.format(*reg) for reg in REGIMES
               if reg in row and row[reg]['invalid']]
        note = ("INVALID at {}: above the card's peak, which no op reaches, "
                'so the time or the FLOP count is wrong; left out of the '
                'aggregates'.format(', '.join(bad)) if bad else '')
        lines.append('| {} | {} | {} | {} | {} | {} | {} |'.format(
            (tr or next(iter(row.values())))['sig'].label(),
            tr['count'] if tr else '-',
            '{:.3f}'.format(tr['total_ms']) if tr else '-',
            *(cell(reg) for reg in REGIMES), note))
    for reg in REGIMES:
        here = [e for e in entries if e['regime'] == reg]
        valid = [e for e in here if not e['invalid']]
        if not here:
            continue
        ms = sum(e['total_ms'] for e in valid)
        tf = sum(e['sig'].flops() * e['count'] for e in valid) / 1e12
        whole = forward[reg]
        lines.append(
            'aggregate B={} crop={}: isolated ops {:.2f} ms, {:.3f} TF -> '
            '{:.1%} MFU; the whole forward {:.2f} ms, {:.3f} TF -> {:.1%} MFU '
            '(isolated / whole time {:.2f}x); {} INVALID entries left '
            'out'.format(reg[0], reg[1], ms, tf,
                         tf / (ms / 1e3) * 1e12 / PEAK_FLOPS, whole['ms'],
                         whole['tf'], whole['mfu'], ms / whole['ms'],
                         len(here) - len(valid)))
    return lines


# ---------------------------------------------------------------- flat

# The per-op table's worst train-shape offenders on the TPU: pointwise
# projections and kTx1x1 temporal convs at the crop-224 res-stage widths.
# (label, B, T, H, W, Cin, Cout, kT)
FLAT_CASES = [
    ('res2 2a 3x1x1', 8, 32, 56, 56, 256, 64, 3),
    ('res2 2c 1x1x1', 8, 32, 56, 56, 64, 256, 1),
    ('res3 2a 3x1x1', 8, 16, 28, 28, 512, 128, 3),
    ('res3 2c 1x1x1', 8, 16, 28, 28, 128, 512, 1),
    ('res4 2a 3x1x1', 8, 16, 14, 14, 1024, 256, 3),
    ('res4 2c 1x1x1', 8, 16, 14, 14, 256, 1024, 1),
    ('res5 2a 3x1x1', 8, 16, 14, 14, 2048, 512, 3),
    ('res5 2c 1x1x1', 8, 16, 14, 14, 512, 2048, 1),
    # crop-256 control: same res4 case at 16x16 spatial
    ('res4 2c @16x16', 8, 16, 16, 16, 256, 1024, 1),
]


def flat_1x1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kTx1x1 conv of ``x`` (B, T, H, W, Cin) by ``w`` (Cout, Cin, kT,
    1, 1), temporal padding kT // 2, as matmuls over (B*T*H*W, Cin): one
    per temporal tap, each added into the result by ``addmm_`` in x's
    dtype (the GEMM sums in f32 and rounds once a tap, where the conv
    rounds once).  A 1x1x1 conv is one matmul on x itself."""
    B, T, H, W, C = x.shape
    kt = w.shape[2]
    taps = w[:, :, :, 0, 0].permute(2, 1, 0).to(x.dtype)     # (kT, Cin, Cout)
    pad = kt // 2
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 0, pad, pad)) if pad else x
    y = torch.matmul(xp[:, :T].reshape(-1, C), taps[0])
    for k in range(1, kt):
        y.addmm_(xp[:, k:k + T].reshape(-1, C), taps[k])
    return y.reshape(B, T, H, W, -1)


def run_flat() -> List[Dict]:
    from lfb_tpu_torch.ops.conv3d import conv3d
    _require_card('flat')
    print('# kTx1x1 conv (cuDNN, channels-last) against flat matmuls, bf16; '
          'card: ' + card_line())
    print('| case | conv ms (MFU) | flat ms (MFU) | speedup | err |')
    print('|---|---|---|---|---|', flush=True)
    results = []
    for label, B, T, H, W, Ci, Co, kT in FLAT_CASES:
        g = torch.Generator('cuda').manual_seed(0)
        x = torch.randn((B, T, H, W, Ci), generator=g, device='cuda',
                        dtype=torch.bfloat16)
        w = torch.randn((Co, Ci, kT, 1, 1), generator=g, device='cuda',
                        dtype=torch.bfloat16) * 0.05
        fl = 2.0 * B * T * H * W * Ci * Co * kT
        conv_fn = lambda x, w: conv3d(x, w, padding=(kT // 2, 0, 0))
        with torch.no_grad():
            t_conv = _timed(conv_fn, (x, w), SIG_ITERS)
            t_flat = _timed(flat_1x1, (x, w), SIG_ITERS)
            a = conv_fn(x, w).float()
            b = flat_1x1(x, w).float()
        err = ((a - b).abs().max() / (a.abs().max() + 1e-9)).item()
        # bf16 inputs and f32 sums on both sides, rounded once a tap on the
        # flat side: beyond 2e-2 relative the flat rewrite computes
        # something else and its speedup means nothing.
        flag = '  <-- MISMATCH, row invalid' if err > 2e-2 else ''
        print('| {} | {:.3f} ({:.1%}) | {:.3f} ({:.1%}) | {:.2f}x | {:.1e} |{}'
              .format(label, t_conv * 1e3, fl / t_conv / PEAK_FLOPS,
                      t_flat * 1e3, fl / t_flat / PEAK_FLOPS,
                      t_conv / t_flat, err, flag), flush=True)
        results.append({'case': label, 'conv_ms': t_conv * 1e3,
                        'flat_ms': t_flat * 1e3, 'err': err})
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('mode', nargs='?', default='all',
                        choices=('grid', 'conv', 'flat', 'all'))
    mode = parser.parse_args(argv).mode
    forward = None
    if mode in ('grid', 'all'):
        forward = run_grid()
    if mode in ('conv', 'all'):
        run_conv(forward)
    if mode in ('flat', 'all'):
        run_flat()


if __name__ == '__main__':
    main()

"""``lfb_tpu_torch.tools.mfu_probe`` on the CPU.

* Its op inventory of the flagship forward (``collect_sigs``, traced on
  fake tensors) equals ``tools/mfu_probe.collect_sigs``'s (imported as
  ``tests/test_mfu_probe.py`` imports it) at each of the probe's regimes,
  as a multiset of (kind, shapes in ``lfb_tpu``'s layouts, strides,
  dilation, groups), with the same FLOPs per signature.  One stated
  difference: the port records conv1 as kind 'stem' (its forward calls
  ``StemConv.apply``, the hand kernel), ``lfb_tpu`` on the CPU as a
  'conv3d' (its Pallas stem runs only on a TPU).  Neither records the FBO
  or the head: both import their own ops.
* Each signature's ``flops()`` equals ``FlopCounterMode``'s count of that
  one op at its real shapes, the dilated res5 convs included.
* The flat rewrite equals ``ops.conv3d``; the per-op table marks an entry
  above the card's peak INVALID and leaves it out of the aggregate; every
  mode raises without a card.
"""

import collections
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip('torch')

from lfb_tpu_torch.ops.conv3d import conv3d  # noqa: E402
from lfb_tpu_torch.tools import mfu_probe  # noqa: E402
from tests.torch_threads import worker_threads  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))


def lfb_tpu_key(sig):
    """A port signature in ``tools/mfu_probe.ConvSig``'s terms."""
    w = sig.w_shape
    if sig.kind in ('conv3d', 'stem'):
        cout, cin_g, kt, kh, kw = w
        w = (kt, kh, kw, cin_g, cout)
    elif sig.kind == 'conv1x1':
        w = (w[1], w[0])
    kind = 'conv3d' if sig.kind == 'stem' else sig.kind
    return (kind, sig.x_shape, w, sig.strides, sig.dilation, sig.groups)


def jax_key(sig):
    w = tuple(sig.w_shape)
    if sig.kind == 'conv1x1':       # (1, 1, 1, Cin, Cout) or (Cin, Cout)
        w = w[-2:]
    return (sig.kind, tuple(sig.x_shape), w, tuple(sig.strides),
            tuple(sig.dilation), sig.groups)


@pytest.fixture(scope='module')
def inventories():
    import mfu_probe as jax_probe
    out = {}
    for B, crop in mfu_probe.REGIMES:
        port = mfu_probe.collect_sigs(mfu_probe._flagship(crop, B)[1], B, crop)
        jax = jax_probe.collect_sigs(
            jax_probe._flagship(train_crop=crop, train_batch=B)[1], B, crop)
        out[(B, crop)] = port, jax
    return out


@pytest.mark.parametrize('regime', mfu_probe.REGIMES)
def test_inventory_matches_lfb_tpu(inventories, regime):
    port, jax = inventories[regime]
    got = collections.Counter()
    for sig, n in port.items():
        got[lfb_tpu_key(sig)] += n
    want = collections.Counter()
    for sig, n in jax.items():
        want[jax_key(sig)] += n
    assert got == want
    assert sum(got.values()) == 129 and len(port) == 33
    # The stated difference: the stem, once, as its own kind.
    stems = {sig: n for sig, n in port.items() if sig.kind == 'stem'}
    assert list(stems.values()) == [1]
    assert next(iter(stems)).w_shape == (64, 3, 5, 7, 7)
    # No FBO-NL call (one query a box) is recorded.
    assert all(sig.x_shape[1] > 1 for sig in port if sig.kind == 'attention')
    jax_flops = {jax_key(sig): sig.flops() for sig in jax}
    for sig in port:
        assert sig.flops() == jax_flops[lfb_tpu_key(sig)], sig.label()


@pytest.mark.parametrize('regime', mfu_probe.REGIMES)
def test_sig_flops_match_flop_counter(inventories, regime):
    port, _ = inventories[regime]
    dilated = [sig for sig in port if sig.dilation != (1, 1, 1)]
    assert dilated and all(sig.out_shape()[1:4] == sig.x_shape[1:4]
                           for sig in dilated)
    for sig in port:
        assert mfu_probe.counted_flops(sig) == sig.flops(), sig.label()


@pytest.mark.parametrize('kt', [1, 3])
def test_flat_rewrite_equals_conv3d(kt):
    g = torch.Generator().manual_seed(kt)
    x = torch.randn((2, 5, 4, 3, 16), generator=g)
    w = torch.randn((24, 16, kt, 1, 1), generator=g)
    torch.testing.assert_close(mfu_probe.flat_1x1(x, w),
                               conv3d(x, w, padding=(kt // 2, 0, 0)),
                               rtol=1e-5, atol=1e-5)


def test_table_marks_entries_above_the_peak_invalid():
    regime = mfu_probe.TRAIN_REGIME
    fast = mfu_probe.ConvSig('conv3d', (8, 16, 14, 14, 512),
                             (512, 512, 1, 3, 3), dilation=(1, 2, 2),
                             padding=(0, 2, 2))
    ok = mfu_probe.ConvSig('conv1x1', (8, 16, 14, 14, 1024), (512, 1024))
    peak_s = lambda sig: sig.flops() / mfu_probe.PEAK_FLOPS  # noqa: E731
    entries = [mfu_probe.conv_entry(fast, regime, 3, peak_s(fast) / 1.25),
               mfu_probe.conv_entry(ok, regime, 2, peak_s(ok) / 0.5)]
    assert [e['invalid'] for e in entries] == [True, False]
    forward = {regime: {'ms': 50.0, 'tf': 4.288, 'mfu': 0.087}}
    lines = mfu_probe.conv_table(entries, forward)
    row = next(line for line in lines if line.startswith('| 1x3x3'))
    assert '125.0% INVALID' in row and "above the card's peak" in row
    other = next(line for line in lines if line.startswith('| 1x1 '))
    assert 'INVALID' not in other and '50.0%' in other
    aggregate = next(line for line in lines if line.startswith('aggregate'))
    assert '{:.3f} TF'.format(2 * ok.flops() / 1e12) in aggregate
    assert '-> 50.0% MFU' in aggregate and '1 INVALID entries' in aggregate


CALLS = {
    'main grid': lambda: mfu_probe.main(['grid']),
    'main conv': lambda: mfu_probe.main(['conv']),
    'main flat': lambda: mfu_probe.main(['flat']),
    'main all': lambda: mfu_probe.main([]),
    'run_grid': mfu_probe.run_grid,
    'run_conv': mfu_probe.run_conv,
    'run_flat': mfu_probe.run_flat,
    'bench_sig': lambda: mfu_probe.bench_sig(mfu_probe.ConvSig(
        'conv1x1', (1, 8), (8, 8))),
}


@pytest.mark.parametrize('call', sorted(CALLS))
def test_every_mode_needs_a_card(call):
    if torch.cuda.is_available():
        pytest.skip('a card is present: the probe runs in chip_smoke.py')
    with pytest.raises(RuntimeError, match='CUDA device'):
        CALLS[call]()


def test_command_exits_non_zero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the probe runs in chip_smoke.py')
    proc = subprocess.run(
        [sys.executable, '-m', 'lfb_tpu_torch.tools.mfu_probe', 'flat'],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0 and '|' not in proc.stdout
    assert 'CUDA device' in proc.stderr

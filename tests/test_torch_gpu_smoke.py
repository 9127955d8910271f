"""``lfb_tpu_torch.tools.gpu_smoke`` on the CPU, where every kernel
wrapper takes its plain version: the training check (4) at 8 frames of
32 x 32 and 2 clips, the row-sharded bank (6) in a one-rank gloo group, the
group step (5) against the CPU step (bitwise: the same code on both sides
here), the attention and RoI checks (1-3) against their plain references,
a failed check's exit, and the command's non-zero exit without a card.
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip('torch')

from lfb_tpu_torch.tools import gpu_smoke  # noqa: E402
from tests.torch_threads import worker_threads  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (8, 32, 2)


def test_training_check(capsys):
    losses = gpu_smoke.check_training('cpu', SIZES)
    assert len(losses) == gpu_smoke.STEPS and losses[-1] < losses[0]
    assert capsys.readouterr().out.startswith('[PASS] bf16 training')


def test_group_step_is_held_in_f32():
    """Why check 5 runs in f32: bf16 rounding alone moves check 4's
    conv1_w update by more than check 5's 2e-2 of its largest element."""
    start = gpu_smoke.TinyRun('cpu', gpu_smoke.CARD_SIZES, seed=1)
    before = start.trainable['conv1_w'].clone()
    updates = []
    for dtype in ('bfloat16', 'float32'):
        run = start.to('cpu')
        run.train_step = gpu_smoke.TinyRun(
            'cpu', gpu_smoke.CARD_SIZES, seed=1,
            compute_dtype=dtype).train_step
        run.step(0)
        updates.append(run.trainable['conv1_w'] - before)
    bf16, f32 = updates
    gap = ((bf16 - f32).abs().max() / f32.abs().max()).item()
    assert gap > 0.1


def test_sharded_bank_check(capsys):
    with gpu_smoke.one_rank_group('cpu'):
        assert torch.distributed.get_backend() == 'gloo'
        assert gpu_smoke.check_sharded_bank('cpu') == 0.0
    assert not torch.distributed.is_initialized()
    assert '[PASS] sharded device bank' in capsys.readouterr().out


def test_group_step_check(capsys):
    start = gpu_smoke.TinyRun('cpu', SIZES, seed=1, compute_dtype='float32')
    before = start.trainable['conv1_w'].clone()
    diff, scale = gpu_smoke.check_group_step('cpu', start)
    assert diff == 0.0 and scale > 0
    assert torch.equal(start.trainable['conv1_w'], before)
    out = capsys.readouterr().out
    assert out.count('[PASS]') == 3 and 'one-rank gloo group' in out


def test_attention_and_roi_checks(capsys):
    gpu_smoke.check_attention('cpu')
    gpu_smoke.check_roi_align('cpu')
    assert capsys.readouterr().out.count('[PASS]') == 5


def test_a_failed_check_exits_non_zero(capsys):
    with pytest.raises(SystemExit) as exit_info:
        gpu_smoke.check('broken', False, 'detail')
    assert exit_info.value.code == 1
    assert capsys.readouterr().out.startswith('[FAIL] broken detail')


def test_command_exits_non_zero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present: chip_smoke.py runs the command')
    with pytest.raises(RuntimeError, match='CUDA device'):
        gpu_smoke.main([])
    proc = subprocess.run(
        [sys.executable, '-m', 'lfb_tpu_torch.tools.gpu_smoke'], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=240)
    assert proc.returncode != 0 and 'all checks passed' not in proc.stdout
    assert 'CUDA device' in proc.stderr

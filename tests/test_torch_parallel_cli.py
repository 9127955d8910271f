"""The port's ``lfb_loader`` and ``test_net`` command lines on two ranks on
the CPU (gloo), against the same command lines on one, and the bank sweep
against ``lfb_tpu``'s on a 2-device mesh (``test_torch_parallel_tools.py``
has ``train_net``).  On the tiny on-disk splits of ``tests/synthetic.py``
with ``test_torch_tools.TINY``'s model:

* ``tools.lfb_loader.main`` with ``NUM_GPUS 2``, Charades val: the bank
  (returned, and the pickle rank 0 wrote) as at ``NUM_GPUS 1`` and as
  ``lfb_tpu``'s mesh sweep, rows within 1e-4 of their largest value
  (``test_torch_tools.assert_same_bank``).
* ``tools.test_net`` under ``torchrun --standalone --nproc_per_node 2``
  (the ranks join the group torchrun sets up), AVA multi-crop: the same
  detections CSVs and merges as ``test_net.main`` on one rank, at most 1%
  of the printed scores tipped (``test_torch_tools.assert_same_files``).
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip('torch')
pytest.importorskip('cv2')

from lfb_tpu.bank import get_lfb as jax_get_lfb  # noqa: E402
from lfb_tpu.core.config import load_config as jax_load_config  # noqa: E402
from lfb_tpu.parallel import create_mesh  # noqa: E402
import lfb_tpu_torch.tools.lfb_loader as port_lfb_loader  # noqa: E402
import lfb_tpu_torch.tools.test_net as port_test_net  # noqa: E402
from tests import synthetic  # noqa: E402
from tests.test_torch_parallel_tools import cli  # noqa: E402
from tests.test_torch_tools import (AVA_YAML, CHARADES_YAML, REPO,  # noqa: E402
                                    TINY, assert_same_bank,
                                    assert_same_files, dataset_opts,
                                    read_bank, save_weights)


def test_lfb_loader_on_two_ranks_charades(tmp_path):
    root = str(tmp_path)
    opts = TINY + ['MODEL.NUM_CLASSES', '6']
    opts += dataset_opts(synthetic.build_charades(root))
    opts = [CHARADES_YAML] + opts + save_weights(CHARADES_YAML, opts, root)
    banks = {w: cli(port_lfb_loader, opts, os.path.join(root, str(w)), w,
                    ['--splits', 'val'])['val'] for w in (1, 2)}
    cfg = jax_load_config(opts[0], opts[1:] + ['LFB.WRITE_LFB', 'False'])
    ref = jax_get_lfb(cfg, cfg.LFB.MODEL_PARAMS_FILE, is_train=False,
                      mesh=create_mesh(2))
    assert len(ref) == 2
    assert_same_bank(banks[2], banks[1])
    assert_same_bank(banks[2], ref)
    assert_same_bank(read_bank(os.path.join(root, '2')), ref)


def test_test_net_under_torchrun_writes_what_one_rank_writes(tmp_path):
    """AVA multi-crop (2 flips x 1 scale x 3 shifts, the bank re-inferred
    per (flip, scale)): the same 6 detections CSVs, 2 merges and final sum
    as one rank."""
    root = str(tmp_path)
    opts = TINY + dataset_opts(synthetic.build_ava(root))
    opts = [AVA_YAML] + opts + save_weights(AVA_YAML, opts, root) + [
        'AVA.TEST_MULTI_CROP', 'True', 'AVA.TEST_MULTI_CROP_SCALES', '[36]']
    dirs = {w: os.path.join(root, 'test_net', str(w)) for w in (1, 2)}
    one = cli(port_test_net, opts, dirs[1], 1)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc_per_node', '2', '-m', 'lfb_tpu_torch.tools.test_net',
         '--config_file', opts[0], '--device', 'cpu'] + opts[1:]
        + ['NUM_GPUS', '2', 'CHECKPOINT.DIR', dirs[2]],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = assert_same_files(dirs[2], dirs[1])
    assert len(names) == 6 + 2 + 1, names
    assert 0 <= one <= 1

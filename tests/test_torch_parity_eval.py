"""The port's parity harness (``python -m lfb_tpu_torch.tools.parity_eval``)
and its copy of the released-blob manifest, against lfb_tpu on the CPU.

* ``released_blob_manifest`` equals lfb_tpu's for every shipped config.
* The tables (``EXPECTED``, ``DRYRUN_CONFIGS``, ``_DRYRUN_SHRINK``), the
  PARITY lines of ``report`` and the fabricated checkpoint are lfb_tpu's.
* ``--dryrun`` on ``--device cpu`` for ``epic_verb_r50_lfb_max`` at f32
  (``TPU.COMPUTE_DTYPE float32``): the same metrics as lfb_tpu's
  ``tools/parity_eval.py`` dry run within 1e-6, its saved predictions
  within 1e-5 of the largest logit, and ``DRYRUN SUMMARY: 1/1``.
* The flagship's multi-crop dry run: ``tests/test_torch_parity_eval_multicrop.py``
  (a file of its own, so that the lane's workers run the two in parallel).
"""

import glob
import importlib.util
import os
import pickle
import shutil

import numpy as np
import pytest

pytest.importorskip('torch')
pytest.importorskip('cv2')

from lfb_tpu.core import config as jax_config  # noqa: E402
from lfb_tpu.train.c2_manifest import \
    released_blob_manifest as jax_manifest  # noqa: E402
from lfb_tpu_torch.core import config as port_config  # noqa: E402
from lfb_tpu_torch.tools import parity_eval  # noqa: E402
from lfb_tpu_torch.train.c2_manifest import released_blob_manifest  # noqa: E402
from lfb_tpu_torch.train.checkpoints import read_pkl  # noqa: E402
from tests.torch_threads import worker_threads  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p)[:-5] for p in glob.glob(
    os.path.join(REPO, 'configs', '*.yaml')))


def reference_tool():
    """``tools/parity_eval.py`` as a module (a script, not a package); its
    ``test_net`` import needs ``tools/`` on the path."""
    import sys
    tools = os.path.join(REPO, 'tools')
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(
        'reference_parity_eval', os.path.join(tools, 'parity_eval.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize('name', CONFIGS)
def test_manifest_matches_lfb_tpu(name):
    path = os.path.join(REPO, 'configs', name + '.yaml')
    assert len(CONFIGS) == 26
    mine = released_blob_manifest(port_config.load_config(path))
    assert mine == jax_manifest(jax_config.load_config(path)) and mine


def test_tables_report_and_weights_match_lfb_tpu(tmp_path, capsys):
    ref = reference_tool()
    assert parity_eval.EXPECTED == ref.EXPECTED
    assert parity_eval.DRYRUN_CONFIGS == ref.DRYRUN_CONFIGS
    assert parity_eval._DRYRUN_SHRINK == ref._DRYRUN_SHRINK
    for case in (('epic_verb_r50_lfb_nl', {'err': 47.5}, 0.5),
                 ('ava_r101_baseline', {'full_map': 0.231}, 0.5),
                 ('charades_r50_lfb_nl', {'full_map': 40.1}, 0.5),
                 ('ava_r101_lfb_nl_3l', 0.2, None),
                 ('not_published', {'full_map': 0.1}, 0.5)):
        outs = []
        for module in (parity_eval, ref):
            ok = module.report(*case)
            outs.append((ok, capsys.readouterr().out))
        assert outs[0] == outs[1], case
    cfg = port_config.load_config(os.path.join(
        REPO, 'configs', 'epic_verb_r50_baseline.yaml'))
    parity_eval.fabricate_released_weights(cfg, str(tmp_path / 'port.pkl'))
    ref.fabricate_released_weights(cfg, str(tmp_path / 'ref.pkl'))
    mine, theirs = (read_pkl(str(tmp_path / f))['blobs']
                    for f in ('port.pkl', 'ref.pkl'))
    assert mine.keys() == theirs.keys()
    for key, value in theirs.items():
        np.testing.assert_array_equal(mine[key], value, err_msg=key)


def test_dryrun_epic_verb_matches_lfb_tpu(tmp_path, monkeypatch, capsys):
    ref = reference_tool()
    name = 'epic_verb_r50_lfb_max'
    opts = ['TPU.COMPUTE_DTYPE', 'float32']
    seen = {}
    for key, module in (('port', parity_eval), ('ref', ref)):
        report = module.report
        monkeypatch.setattr(module, 'report', lambda n, m, tolerance=None,
                            _key=key, _report=report: (
                                seen.setdefault(_key, m),
                                _report(n, m, tolerance))[1])
    parity_eval.main(['--dryrun', str(tmp_path / 'port'), '--config', name,
                      '--device', 'cpu'] + opts)
    assert 'DRYRUN SUMMARY: 1/1 paths exercised' in capsys.readouterr().out
    assert ref.dryrun_one(name, str(tmp_path / 'ref'), opts)
    assert seen['port'].keys() == seen['ref'].keys()
    for key, value in seen['ref'].items():
        assert abs(seen['port'][key] - value) <= 1e-6, key
    preds = []
    for side in ('port', 'ref'):
        with open(tmp_path / side / name / 'epic_predictions_final.pkl',
                  'rb') as f:
            preds.append(pickle.load(f))
    (logits, labels), (ref_logits, ref_labels) = preds
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(logits, ref_logits, rtol=0,
                               atol=1e-5 * np.abs(ref_logits).max())
    shutil.rmtree(tmp_path)     # the two runs' splits and pickles, 0.8 GB

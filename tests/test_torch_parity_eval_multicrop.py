"""The port's parity harness on the flagship, on the CPU: its dry run
(``lfb_tpu_torch/tools/parity_eval.py:dryrun_one``, multi-crop testing: 2
flips x 1 scale x 3 shifts, the bank inferred again for each flip) ends with
a finite mAP and writes the six per-crop detections CSVs and the merged
result.  It takes about 65 s alone, most of it fabricating and loading the
0.4 GB R101 pickles (once per crop).
"""

import glob
import shutil

import pytest

pytest.importorskip('torch')
pytest.importorskip('cv2')

from lfb_tpu_torch.tools import parity_eval  # noqa: E402
from tests.torch_threads import worker_threads  # noqa: E402,F401


def test_dryrun_flagship_multicrop_ends_with_a_finite_map(tmp_path,
                                                          monkeypatch):
    name = 'ava_r101_lfb_nl_3l'
    seen = []
    report = parity_eval.report
    monkeypatch.setattr(parity_eval, 'report', lambda n, m, tolerance=None: (
        seen.append(m), report(n, m, tolerance))[1])
    assert parity_eval.dryrun_one(name, str(tmp_path), device='cpu')
    (full_map,) = seen
    assert isinstance(full_map, float) and 0.0 <= full_map <= 1.0
    root = tmp_path / name
    assert (root / 'final_multi_crop_testing_results.csv').is_file()
    assert len(glob.glob(str(root / 'detections_final_64*_shift*.csv'))) == 6
    shutil.rmtree(tmp_path)     # the split and the R101 pickles, 0.7 GB

"""AVA multi-crop testing through the port's ``test_net`` command line on
the CPU, against ``tools/test_net.py``'s: 2 flips x 1 scale x 3 shifts, the
bank re-inferred per (flip, scale), the visibility-gated merges and the
final sum, on the tiny on-disk AVA split (tolerances as in
``test_torch_tools.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
cv2 = pytest.importorskip('cv2')

from tests import synthetic  # noqa: E402
from tests.test_torch_tools import (AVA_YAML, TINY,  # noqa: E402
                                    assert_same_files, dataset_opts, run_both,
                                    save_weights)


def test_test_net_ava_multi_crop_matches_lfb_tpu(tmp_path):
    root = str(tmp_path)
    opts = TINY + dataset_opts(synthetic.build_ava(root))
    opts += save_weights(AVA_YAML, opts, root)
    opts = opts + ['AVA.TEST_MULTI_CROP', 'True',
                   'AVA.TEST_MULTI_CROP_SCALES', '[36]']
    port, ref, port_dir, ref_dir = run_both(AVA_YAML, opts, root, 'multi')
    names = assert_same_files(port_dir, ref_dir)
    # 2 flips x 3 shifts, 2 merged files, the final sum.
    assert len(names) == 6 + 2 + 1, names
    assert 0 <= port <= 1
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6)

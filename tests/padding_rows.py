"""A padding row's output in the port: the steps run the FBO on an AVA
batch's real rows alone (``box_mask`` 1), and a padding row's FBO part is
0, so its logits are the classifier over [its head row, 0]
(``lfb_tpu_torch.models.fbo``).  ``lfb_tpu`` runs the FBO over a padding
row's window too, so the tests compare the real rows with ``lfb_tpu`` and
pin the padding rows to this, bit for bit.

Imports torch and the port only, so the spawned ranks of
``tests/torch_parallel_ranks.py`` use it too.
"""

import contextlib

import numpy as np
import torch

from lfb_tpu_torch.models.model import LFBModel


@contextlib.contextmanager
def classifier_inputs():
    """Within the block, each :meth:`LFBModel.run` call's (head rows, its
    'box_pooled' or 'pool5' output; 'pred_w'; 'pred_b'), as that call read
    them, in call order (copies: a train step updates its weights in
    place)."""
    seen = []
    run = LFBModel.run

    def recording(self, p, batch, **kwargs):
        out = run(self, p, batch, **kwargs)
        head = out['box_pooled'] if 'box_pooled' in out else out['pool5']
        seen.append(tuple(None if t is None else t.detach().clone()
                          for t in (head, p.get('pred_w'), p.get('pred_b'))))
        return out

    LFBModel.run = recording
    try:
        yield seen
    finally:
        LFBModel.run = run


def padding_prob(record, latent_dim: int) -> np.ndarray:
    """Every row's sigmoid prob as a padding row's: the classifier over
    [head row, 0] (``record`` one entry of :func:`classifier_inputs`)."""
    box_pooled, pred_w, pred_b = record
    head = box_pooled.float()
    with torch.no_grad():
        head = torch.cat([head, head.new_zeros((head.shape[0], latent_dim))],
                         dim=-1)
        return torch.sigmoid(head @ pred_w.t() + pred_b).numpy()


def assert_padding_rows(prob, expected, box_mask) -> None:
    """The rows of ``prob`` with ``box_mask`` 0 are ``expected``'s, bit for
    bit; there is at least one."""
    pad = np.asarray(box_mask) == 0
    assert pad.any()
    np.testing.assert_array_equal(np.asarray(prob)[pad],
                                  np.asarray(expected)[pad])

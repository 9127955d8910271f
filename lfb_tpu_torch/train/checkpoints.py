"""Checkpoint I/O, including the Caffe2-pickle compatibility layer: the
port's own copy of ``lfb_tpu/train/checkpoints.py``.

The released reference weights are Python-2 pickles of
``{'blobs': {unscoped_name: float32 ndarray}}`` plus ``model_iter``, ``lr``
and ``*_momentum`` entries (reference ``lib/utils/checkpoints.py:421-459``).
The port's params have the blob names and Caffe2's layout, (Cout, Cin/g,
kT, kH, kW) conv kernels and (Cout, Cin) FC weights, so a blob loads as it
is, with two exceptions (:func:`c2_to_port`):

  Caffe2 (Cout, Cin, kH, kW) 2D conv  ->  inflated over kT, divided by kT
                                          (``checkpoints.py:336-362``)
  ``pred_*`` of another size          ->  skipped (``checkpoints.py:321-334``)

Also implemented, matching the reference load path:
  * BN->affine folding for CONVERT_MODEL finetunes (``checkpoints.py:88-116``)
  * resume discovery of ``c2_model_iter*.pkl`` (``checkpoints.py:51-69``)
  * batch-size-change iteration rescaling (``checkpoints.py:240-246``)

Checkpoints are written in the same pickle container (protocol 2), so the
reference's, ``lfb_tpu``'s and the port's checkpoints are interchangeable.
:func:`tpu_to_c2` carries one ``lfb_tpu`` parameter array into the port's
layout (``convert.params_from_jax``).  ``tests/test_torch_checkpoints.py``
holds this module to the original.
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------- #
# Low-level container I/O
# --------------------------------------------------------------------------- #

def read_pkl(path: str, retry: int = 10) -> dict:
    """Read a (possibly Python-2) Caffe2 pickle, retrying transient I/O
    failures (reference ``checkpoints.py:133-142,276-284``)."""
    for attempt in range(retry):
        try:
            with open(path, 'rb') as f:
                try:
                    data = pickle.load(f, encoding='latin1')
                except TypeError:  # pragma: no cover (py2-free env)
                    f.seek(0)
                    data = pickle.load(f)
            break
        except (OSError, EOFError) as e:
            if isinstance(e, FileNotFoundError):
                raise
            if attempt == retry - 1:
                raise
            time.sleep(1.0)
    # Normalize bytes keys from py2 pickles.
    def denorm(obj):
        if isinstance(obj, dict):
            return {
                (k.decode() if isinstance(k, bytes) else k): denorm(v)
                for k, v in obj.items()}
        return obj
    return denorm(data)


def write_pkl(path: str, data: dict) -> None:
    with open(path, 'wb') as f:
        pickle.dump(data, f, protocol=2)


# --------------------------------------------------------------------------- #
# Layout transforms
# --------------------------------------------------------------------------- #

def c2_to_port(name: str, value: np.ndarray,
               target_shape: Tuple[int, ...]) -> Optional[np.ndarray]:
    """Convert one Caffe2 blob to the port's tensor of ``target_shape``.

    Returns None when the blob must be skipped (classifier size mismatch).
    """
    value = np.asarray(value, dtype=np.float32)
    if name.startswith('pred_'):
        if value.size != int(np.prod(target_shape)):
            logger.info('%s (classifier) found but unmatching (not loaded): '
                        '%s ---> %s', name, value.shape, target_shape)
            return None
        return np.ascontiguousarray(value.reshape(target_shape))
    if value.ndim == 4 and len(target_shape) == 5:
        # 2D (image-pretrained) kernel -> inflate over the new temporal axis.
        kt = target_shape[2]
        out = np.stack([value] * kt, axis=2) / float(kt)
    else:
        out = value
    if out.shape != tuple(target_shape):
        raise ValueError(
            'Blob {} with shape {} does not match target shape {}'.format(
                name, value.shape, target_shape))
    return np.ascontiguousarray(out)


def tpu_to_c2(name: str, value: np.ndarray) -> np.ndarray:
    """An ``lfb_tpu`` array -> Caffe2 layout: (kT, kH, kW, Cin, Cout) conv
    kernels to (Cout, Cin, kT, kH, kW), (Cin, Cout) FC weights to (Cout, Cin),
    1-D arrays unchanged."""
    value = np.asarray(value, dtype=np.float32)
    if value.ndim == 5:
        return np.ascontiguousarray(np.transpose(value, (4, 3, 0, 1, 2)))
    if value.ndim == 2:
        return np.ascontiguousarray(value.T)
    return value


# --------------------------------------------------------------------------- #
# BN -> affine folding
# --------------------------------------------------------------------------- #

def fold_bn_to_affine(blobs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold every ``*_bn_{rm,riv}`` pair into the ``*_bn_{s,b}`` scale/bias
    (reference ``remove_spatial_bn_layers``, ``checkpoints.py:88-116``)."""
    out = dict(blobs)
    done = set()
    for name in sorted(blobs):
        idx = name.find('_bn_')
        if idx < 0:
            continue
        layer = name[:idx]
        if layer in done:
            continue
        done.add(layer)
        rm_name, rv_name = layer + '_bn_rm', layer + '_bn_riv'
        if rm_name not in blobs or rv_name not in blobs:
            continue
        scale = blobs[layer + '_bn_s']
        bias = blobs[layer + '_bn_b']
        std = np.sqrt(blobs[rv_name] + 1e-5)
        out[layer + '_bn_s'] = scale / std
        out[layer + '_bn_b'] = bias - blobs[rm_name] * scale / std
        del out[rm_name]
        del out[rv_name]
    return out


def convert_pretrained(blobs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """CONVERT_MODEL path: strip classifier/momentum, fold BN (reference
    ``convert_model`` + ``load_and_convert_caffe2_cls_model``,
    ``checkpoints.py:132-177``)."""
    blobs = {k: v for k, v in blobs.items()
             if not (k in ('epoch', 'model_iter', 'lr')
                     or k.endswith('_momentum') or 'pred' in k)}
    return fold_bn_to_affine(blobs)


# --------------------------------------------------------------------------- #
# High-level load / save
# --------------------------------------------------------------------------- #

def _loaded(name: str, blob, target: torch.Tensor,
            device: torch.device | str) -> torch.Tensor:
    """The blob converted for ``target`` (f32 on ``device``), or ``target``
    there when the blob is skipped."""
    value = c2_to_port(name, blob, tuple(target.shape))
    if value is None:
        return target.to(device=device, dtype=torch.float32)
    return torch.from_numpy(value).to(device)


def load_params_into(
    path: str,
    params: Mapping[str, torch.Tensor],
    *,
    convert_model: bool = False,
    load_momentum: bool = False,
    momentum: Optional[Mapping[str, torch.Tensor]] = None,
    device: torch.device | str = 'cuda',
) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]], int,
           float]:
    """Load a Caffe2 / lfb_tpu / port pickle into the port's ``params``.

    Returns (new_params, new_momentum, model_iter, prev_lr), every tensor f32
    on ``device``.  Missing blobs keep their values (logged), extra blobs
    are ignored -- same behavior as reference
    ``initialize_master_gpu_model_params``.  ``momentum`` (the buffers of
    an ``SGDState``) loads from the ``*_momentum`` blobs when
    ``load_momentum``.
    """
    data = read_pkl(path)
    blobs = data.get('blobs', data)
    model_iter = int(blobs.get('model_iter', 0))
    prev_lr = float(blobs.get('lr', 1.0))
    clean = {k: v for k, v in blobs.items()
             if k not in ('model_iter', 'lr', 'epoch')}
    if convert_model:
        clean = convert_pretrained(clean)

    new_params = {}
    for name, target in params.items():
        if name not in clean:
            logger.info('%s not found in %s', name, os.path.basename(path))
            new_params[name] = target.to(device=device, dtype=torch.float32)
            continue
        new_params[name] = _loaded(name, clean[name], target, device)

    new_momentum = None
    if load_momentum and momentum is not None:
        new_momentum = {}
        for name, target in momentum.items():
            mname = name + '_momentum'
            new_momentum[name] = (
                _loaded(name, clean[mname], target, device) if mname in clean
                else target.to(device=device, dtype=torch.float32))
    return new_params, new_momentum, model_iter, prev_lr


def _host(value: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(
        value.detach().to('cpu', torch.float32).numpy())


def save_params(
    path: str,
    params: Mapping[str, torch.Tensor],
    *,
    model_iter: int,
    lr: float,
    momentum: Optional[Mapping[str, torch.Tensor]] = None,
) -> None:
    """Write a Caffe2-compatible checkpoint pickle."""
    blobs: Dict[str, np.ndarray] = {}
    blobs['model_iter'] = model_iter
    blobs['lr'] = np.array(lr, dtype=np.float32)
    for name, value in params.items():
        blobs[name] = _host(value)
    if momentum:
        for name, value in momentum.items():
            blobs[name + '_momentum'] = _host(value)
    write_pkl(path, dict(blobs=blobs))


# --------------------------------------------------------------------------- #
# Resume discovery
# --------------------------------------------------------------------------- #

def checkpoint_directory(cfg) -> str:
    assert cfg.CHECKPOINT.DIR, 'No cfg.CHECKPOINT.DIR specified.'
    return os.path.abspath(os.path.join(cfg.CHECKPOINT.DIR, 'checkpoints'))


def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """Find the newest ``c2_model_iter{N}.pkl`` (reference
    ``get_checkpoint_resume_file``)."""
    if not os.path.isdir(checkpoint_dir):
        return None
    iters = []
    for f in os.listdir(checkpoint_dir):
        if f.startswith('c2_model_iter') and f.endswith('.pkl'):
            try:
                iters.append(int(f[len('c2_model_iter'):-len('.pkl')]))
            except ValueError:
                continue
    if not iters:
        return None
    return os.path.join(checkpoint_dir,
                        'c2_model_iter{}.pkl'.format(max(iters)))


def resume_iter_for_batch_size(start_iter: int, old_batch: int,
                               new_batch: int) -> int:
    """Rescale the resume iteration when batch size changed (reference
    ``resume_from``, ``checkpoints.py:240-246``)."""
    assert old_batch > 0
    return int(start_iter * old_batch / new_batch)

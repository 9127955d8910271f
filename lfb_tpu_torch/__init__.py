"""lfb_tpu_torch: the PyTorch + CUDA port of lfb_tpu for NVIDIA Hopper.

The JAX package ``lfb_tpu`` stays the reference.  This package mirrors its
layout (``models/``, ``ops/``, ``bank/``, ``train/``) so each counterpart is
found by its path, imports ``torch`` and never ``jax``, and keeps the Caffe2
blob names and layout for parameters.  Every TPU kernel on the ported path
has a hand-written CUDA kernel under ``csrc/``, built on the first CUDA call;
a CUDA tensor always goes through it, a CPU tensor through its plain PyTorch
version.
"""

__version__ = "0.1.0"

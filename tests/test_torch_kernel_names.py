"""The kernel lists of ``chip_smoke.py`` name kernels that exist.

``chip_smoke.MMA_KERNELS`` must show tensor-core instructions in their
SASS and ``WGMMA_KERNELS`` HGMMA (``wgmma``) with no serialisation note;
the script finds them by name, so a kernel renamed in ``csrc/`` without
the lists would drop its check unnoticed.  Each listed name must be
defined as a ``__global__`` function in ``lfb_tpu_torch/csrc/*.cu``.
"""

import re
from pathlib import Path

import pytest

import chip_smoke

CSRC = Path(__file__).resolve().parent.parent / 'lfb_tpu_torch' / 'csrc'


def kernel_names():
    """The names of the ``__global__`` functions of ``csrc/*.cu``."""
    names = set()
    for src in sorted(CSRC.glob('*.cu')):
        text = src.read_text()
        names.update(re.findall(
            r'__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(',
            text))
    return names


def test_the_sources_define_kernels():
    assert len(kernel_names()) >= 10


@pytest.mark.parametrize('name', chip_smoke.MMA_KERNELS)
def test_each_tensor_core_kernel_listed_is_defined(name):
    assert name in kernel_names(), (name, sorted(kernel_names()))


@pytest.mark.parametrize('name', chip_smoke.WGMMA_KERNELS)
def test_each_wgmma_kernel_listed_is_defined_and_a_tensor_core_kernel(name):
    assert name in kernel_names(), (name, sorted(kernel_names()))
    assert name in chip_smoke.MMA_KERNELS


@pytest.mark.parametrize('name', ['attn_fwd_wgmma_kernel',
                                  'attn_bwd_dkdv_wgmma_kernel',
                                  'attn_bwd_dq_wgmma_kernel'])
def test_the_attention_kernels_are_held_to_wgmma(name):
    """The bf16 attention kernels run on wgmma: their HGMMA is checked."""
    assert name in chip_smoke.WGMMA_KERNELS


@pytest.mark.parametrize('name', ['stem_dw_wgmma_kernel',
                                  'fused_bottleneck_wgmma_kernel'])
def test_the_stem_dw_and_bottleneck_kernels_are_held_to_wgmma(name):
    """The bf16 stem weight gradient and fused bottleneck run on wgmma: their
    HGMMA is checked, and the mma.sync kernels they replaced are gone."""
    assert name in chip_smoke.WGMMA_KERNELS
    assert name in kernel_names()
    assert not {'stem_dw_mma_kernel',
                'fused_bottleneck_mma_kernel'} & kernel_names()


def test_the_serialisation_note_is_found_by_kernel():
    log = '\n'.join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_121attn_fwd_wgmma_kernelILb0EEEv' for 'sm_90a'",
        "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized due to non wgmma instructions defining "
        "accumulator registers of a wgmma between start and end of the "
        "pipeline stage in the function "
        "'_ZN12_GLOBAL__N_124attn_bwd_dq_wgmma_kernelILb1EEEv'",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_122stem_conv_wgmma_kernelEv' for 'sm_90a'",
        "ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized due to the presence of non-uniform "
        "control flow",
        "ptxas info    : Used 168 registers, used 16 barriers"])
    assert chip_smoke.serialized_wgmma(log) == [
        'attn_bwd_dq_wgmma_kernel', 'stem_conv_wgmma_kernel']
    assert chip_smoke.serialized_wgmma('ptxas info    : Used 40 '
                                       'registers') == []

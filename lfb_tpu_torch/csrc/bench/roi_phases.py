"""Where the RoI + max-pool kernels spend their device time: the kernels of
``csrc/roi_align_maxpool.cu`` as built, then copies of that source with one
phase cut out each (the map's copy into shared memory, the bin sums, the
backward's scatter, its write of d fmap), and the kernels at each channel
chunk, all timed by ``chip_smoke.device_ms`` at the main path's shapes
(phase B: fmap (16, 16, 16, 2048), 64 rois; the train step: (8, 14, 14,
2048), 32 rois).  A copy with a phase cut out computes garbage; only its time
is read.  Run from the root of a checkout on a machine with an sm_90a card:

    python3 lfb_tpu_torch/csrc/bench/roi_phases.py

The variants build with nvcc into ``build/roi_phases/``.
"""

import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from lfb_tpu_torch.ops import cuda_build, cuda_roi_align  # noqa: E402

CSRC = ROOT / 'lfb_tpu_torch' / 'csrc'
SHAPES = [('phase B', (16, 16, 16, 2048), 256), ('train', (8, 14, 14, 2048), 224)]


def cut(src, old, new):
    if old not in src and not re.search(old, src):
        raise SystemExit('roi_phases: the source has no {!r}'.format(old))
    return re.sub(old, new, src)


def variants():
    src = (CSRC / 'roi_align_maxpool.cu').read_text()
    no_copy = cut(src, r'stage_slice<kVec>\(', 'skip_copy(').replace(
        'namespace {\n', 'namespace {\ntemplate <typename... A> '
        '__device__ void skip_copy(A...) {}\n', 1)
    return {
        'as built': src,
        'no map copy': no_copy,
        'no bin sums': cut(src, r'j < pp; j \+= groups', 'j < 0; j += groups'),
        'no scatter': cut(src, r'for \(int iy = 0; iy < bt\.yn\[ph\]; \+\+iy\)',
                          'for (int iy = 0; iy < 0; ++iy)'),
        'no d fmap write': cut(src, r'\n      write_slice<kVec>\(dst, buf, HW, C, '
                               r'valid, lq, false\);', ''),
    }


def build():
    out = ROOT / 'build' / 'roi_phases'
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, text) in enumerate(variants().items()):
        cu = out / 'v{}.cu'.format(i)
        cu.write_text(text.replace('#include "', '#include "{}/'.format(CSRC)))
        so = out / 'v{}.so'.format(i)
        procs.append((name, so, subprocess.Popen(
            [cuda_build._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
             '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC', '-o',
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit('roi_phases: {} did not build:\n{}'.format(name,
                                                                        log))
        lib = ctypes.CDLL(str(so))
        for fn in ('lfb_roi_align_maxpool', 'lfb_roi_align_maxpool_bwd'):
            getattr(lib, fn).argtypes = cuda_build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def best_ms(fn):
    return min(chip_smoke.device_ms(fn) for _ in range(3))


def main():
    chip_smoke.preamble()
    libs = build()
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    rng = np.random.default_rng(chip_smoke.SEED)
    for label, shape, crop in SHAPES:
        B, H, W, C = shape
        fmap = torch.relu(torch.randn(shape, generator=g, device=dev))
        rois = torch.from_numpy(chip_smoke.rand_rois(rng, B, 4, crop)).to(dev)
        N = rois.shape[0]
        dout = torch.randn((N, C), generator=g, device=dev)
        out = torch.empty((N, C), device=dev)
        dfmap = torch.empty_like(fmap)
        chunk = cuda_roi_align.channel_chunk(H, W, C, backward=False)
        bwd_chunk = cuda_roi_align.channel_chunk(H, W, C, backward=True)
        stream = torch.cuda.current_stream().cuda_stream
        chip_smoke.log('{} fmap {} rois {}: chunks {} / {} (forward / '
                       'backward)'.format(label, shape, N, chunk, bwd_chunk))
        for name, lib in libs.items():
            fwd = best_ms(lambda: lib.lfb_roi_align_maxpool(
                fmap.data_ptr(), rois.data_ptr(), out.data_ptr(), B, H, W, C,
                N, 7, 1 / 16, chunk, 1, stream))
            bwd = best_ms(lambda: lib.lfb_roi_align_maxpool_bwd(
                fmap.data_ptr(), rois.data_ptr(), dout.data_ptr(),
                dfmap.data_ptr(), B, H, W, C, N, 7, 1 / 16, bwd_chunk, 1,
                stream))
            chip_smoke.log('  {:16s} forward {:.4f} ms, backward {:.4f} '
                           'ms'.format(name, fwd, bwd))
        lib = libs['as built']
        for cc in cuda_roi_align.CHUNKS[:4]:
            fwd = best_ms(lambda: lib.lfb_roi_align_maxpool(
                fmap.data_ptr(), rois.data_ptr(), out.data_ptr(), B, H, W, C,
                N, 7, 1 / 16, cc, 1, stream))
            bwd = best_ms(lambda: lib.lfb_roi_align_maxpool_bwd(
                fmap.data_ptr(), rois.data_ptr(), dout.data_ptr(),
                dfmap.data_ptr(), B, H, W, C, N, 7, 1 / 16, cc, 1, stream))
            chip_smoke.log('  chunk {:2d}: forward {:.4f} ms, backward {:.4f} '
                           'ms'.format(cc, fwd, bwd))
    chip_smoke.log('card: ' + chip_smoke.card_line())


if __name__ == '__main__':
    main()

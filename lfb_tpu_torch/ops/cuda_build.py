"""Build and load the hand-written CUDA kernels of ``lfb_tpu_torch/csrc``.

All ``csrc/*.cu`` sources compile with ``nvcc`` into ONE shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), keyed by
a hash of the sources, under ``build/lfb_tpu_torch/`` beside the package.
The build runs on the first CUDA call, never at import; it writes to a
temporary name and renames, so a concurrent build never loads a partial
file.  The library is loaded with ``ctypes`` and every launcher gets its
``argtypes`` (``c_void_p`` for pointers and the stream).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = CSRC.parent.parent / 'build' / 'lfb_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Launcher name -> argtypes; every launcher returns a cudaError_t (int).
SIGNATURES = {
    'lfb_attention_f32': (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    'lfb_attention_bf16': (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    'lfb_roi_align_maxpool': (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    'lfb_stem_conv_f32': (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    'lfb_stem_conv_bf16': (_P, _P, _P, _I, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
# What the last build printed (ptxas register / shared-memory report) and how
# long it took; empty when the library came from an earlier build.
build_log = ''
build_seconds = 0.0


def _sources():
    return sorted(CSRC.glob('*.cu')) + sorted(CSRC.glob('*.cuh'))


def _nvcc() -> str:
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(Path(os.environ['CUDA_HOME']) / 'bin' / 'nvcc')
    candidates.append(Path('/usr/local/cuda/bin/nvcc'))
    for path in candidates:
        if path.is_file():
            return str(path)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError(
            'nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and '
            'PATH): the lfb_tpu_torch CUDA kernels cannot be built')
    return found


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / 'liblfb_kernels_{}.so'.format(digest.hexdigest()[:16])


def _build(target: Path) -> None:
    global build_log, build_seconds
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name('{}.{}.tmp'.format(target.name, os.getpid()))
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
           *[str(s) for s in sorted(CSRC.glob('*.cu'))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError('nvcc failed ({}):\n{}'.format(
            ' '.join(cmd), build_log))
    os.replace(tmp, target)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if no build of these sources
    exists."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call launcher ``name`` on the current stream; raise if CUDA refused
    the launch."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError('{} failed: cudaError_t {} (driver_types.h)'.format(
            name, err))

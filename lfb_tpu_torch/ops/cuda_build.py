"""Build and load the hand-written CUDA kernels of ``lfb_tpu_torch/csrc``.

Each ``csrc/*.cu`` source compiles with its own ``nvcc`` process, all
started together, and the objects link into ONE shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), keyed by a hash
of the sources, under ``build/lfb_tpu_torch/`` beside the package.  The
build runs on the first CUDA call, never at import; it writes to a temporary
name and renames, so a concurrent build never loads a partial file.  The library is loaded with ``ctypes`` and every launcher gets its
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
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Launcher name -> argtypes; every launcher returns a cudaError_t (int).
SIGNATURES = {
    'lfb_attention_f32': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    'lfb_attention_bf16': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    'lfb_attention_bwd_f32': (_P,) * 9 + (_I, _I, _I, _I, _F, _P),
    'lfb_attention_bwd_bf16': (_P,) * 9 + (_I, _I, _I, _I, _F, _P),
    'lfb_fused_bottleneck_f32': (_P,) * 8 + (_I,) * 8 + (_P,),
    'lfb_fused_bottleneck_bf16': (_P,) * 8 + (_I,) * 8 + (_P,),
    'lfb_roi_align_maxpool': (_P, _P, _P) + (_I,) * 6 + (_F, _I, _I, _P),
    'lfb_roi_align_maxpool_bwd': (_P,) * 4 + (_I,) * 6 + (_F, _I, _I, _P),
    'lfb_stem_conv_f32': (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    'lfb_stem_conv_bf16': (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    'lfb_stem_conv_dw_f32': (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    'lfb_stem_conv_dw_bf16': (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
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
    tag = '{}.{}'.format(target.stem, os.getpid())
    nvcc = _nvcc()
    sources = sorted(CSRC.glob('*.cu'))
    objects = [target.with_name('{}.{}.o'.format(tag, src.stem))
               for src in sources]
    tmp = target.with_name('{}.so.tmp'.format(tag))
    t0 = time.perf_counter()
    compiles = []
    for src, obj in zip(sources, objects):
        cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', str(obj), str(src)]
        compiles.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, proc in compiles:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(' '.join(cmd))
    if not failed:
        link = [nvcc, '-shared', '-o', str(tmp), *map(str, objects)]
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(' '.join(link))
    build_seconds = time.perf_counter() - t0
    build_log = ''.join(logs)
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError('nvcc failed ({}):\n{}'.format(
            '; '.join(failed), build_log))
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

"""Build and load the port's CUDA kernels.

Each kernel source under ``csrc/`` is compiled at first use with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
in ``_build/`` beside this package, named by a hash of the source, the
shared headers ``csrc/*.cuh`` and the flags, and loaded with ``ctypes``.
Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(PKG_DIR, '_build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']


def source(name: str) -> str:
    """Path of the kernel source ``csrc/<name>``."""
    return os.path.join(CSRC_DIR, name)


def _nvcc(src: str) -> str:
    for var in ('CUDA_HOME', 'CUDA_PATH'):
        root = os.environ.get(var)
        if root and os.path.isfile(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'  # the toolkit's standard place
    if os.path.isfile(default):
        return default
    raise RuntimeError('nvcc not found (set CUDA_HOME): the kernel is '
                       'built from %s at first use' % src)


def build(src: str) -> tuple:
    """Compile ``src`` if its library is missing; returns ``(library
    path, compiler log)``.  The log holds ``-Xptxas -v``'s registers,
    shared memory and spills (empty when already built).  An edit of
    ``src`` or of any header beside it builds anew."""
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(os.path.dirname(src), '*.cuh')))
    for name in [src] + headers:
        with open(name, 'rb') as fh:
            digest.update(fh.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    path = os.path.join(BUILD_DIR,
                        '%s-%s.so' % (stem, digest.hexdigest()[:16]))
    if os.path.isfile(path):
        return path, ''
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(src)] + NVCC_FLAGS + ['-o', tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed to build %s:\n%s%s'
                               % (src, proc.stdout, proc.stderr))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, proc.stdout + proc.stderr


# serialises first builds: threads that serve jobs may reach a kernel
# at once, and each source is built by one nvcc run
_BUILD_LOCK = threading.Lock()
# guards the launch counters' read-modify-write
_COUNT_LOCK = threading.Lock()
_LOADED: dict = {}   # source path -> its loaded library


def load(src: str) -> ctypes.CDLL:
    """The library built from ``src``, loaded once per process (one
    build even when several threads ask at once; a loaded library is
    returned without the lock)."""
    lib = _LOADED.get(src)
    if lib is None:
        with _BUILD_LOCK:
            lib = _LOADED.get(src)
            if lib is None:
                lib = _LOADED[src] = ctypes.CDLL(build(src)[0])
    return lib


def count(fn, attr: str = 'launches', n: int = 1) -> None:
    """Add ``n`` to the launch counter ``fn.<attr>`` (under a lock: a
    plain ``+= 1`` from several threads can lose counts)."""
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + n)


def check(name, t, shape, dtype, device):
    """Raise unless tensor ``t`` lies on ``device`` with ``dtype``,
    ``shape`` and a contiguous layout (what a kernel takes)."""
    if t.device != device:
        raise ValueError('%s is on %s, expected %s' % (name, t.device,
                                                       device))
    if t.dtype != dtype:
        raise ValueError('%s has dtype %s, expected %s' % (name, t.dtype,
                                                           dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError('%s has shape %s, expected %s'
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError('%s must be contiguous' % name)


def one_device(name, tensors):
    """The one device all ``tensors`` lie on; raises when they span
    several."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError('%s inputs span devices %s'
                         % (name, sorted(map(str, devices))))
    return devices.pop()

"""Host C++ components of the port, built with ``g++`` and loaded with
``ctypes``.

Three sources under ``native_src/`` (the port's own copies; host code,
no kernels): ``decode_prep.cpp`` (:func:`decode_scan`,
:func:`decode_fill`, :func:`decode_emit`: the run merging, array fill
and path emission of the decode kernels' host prep),
``page_scan.cpp`` (the byte-level PAGE-XML scanner of
``wrapper/page_native.py``) and ``stream_loader.cpp``
(:func:`build_stream_batches`, the training windows of
``data.gen_stateful_streams``).

Each is compiled at first use with ``g++ -O3 -shared -fPIC -std=c++17``
into ``_build/`` beside this package (``KERASLM_NATIVE_DIR`` overrides
the directory), named by a hash of the source and the flags, written to
a per-process temporary file and moved into place, so processes that
build at once on a cold cache never load a partial library.  Nothing is
built at import.

``KERASLM_NATIVE=0`` chooses the Python lanes: the loaders return None
and the callers take their Python (or numpy) equivalents.  Otherwise
the native lane is asked for, and a failed build raises with the
compiler's output.  ``KERASLM_NATIVE_SANITIZE=1`` builds with ASAN and
UBSAN (the scanner parses untrusted bytes).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
from typing import Optional

import numpy as np

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(PKG_DIR, 'native_src')
CXX_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']

_LOCK = threading.Lock()
_LIBS: dict = {}


def enabled() -> bool:
    """Whether the native lane is asked for (``KERASLM_NATIVE`` is not
    ``0``)."""
    return os.environ.get('KERASLM_NATIVE') != '0'


def _sanitized() -> bool:
    return os.environ.get('KERASLM_NATIVE_SANITIZE') == '1'


def build_dir() -> str:
    return os.environ.get('KERASLM_NATIVE_DIR') or \
        os.path.join(PKG_DIR, '_build')


def python_include() -> str:
    """The CPython headers the scanner and the decode prep compile
    against."""
    return sysconfig.get_paths()['include']


def _flags(extra=()) -> list:
    flags = list(CXX_FLAGS) + list(extra)
    if _sanitized():
        # -O1 (after -O3) and frame pointers for usable reports
        flags += ['-fsanitize=address,undefined',
                  '-fno-sanitize-recover=all', '-fno-omit-frame-pointer',
                  '-g', '-O1']
    return flags


def build(name: str, extra=()) -> str:
    """Compile ``native_src/<name>`` if its library is missing; returns
    the library's path.  Raises ``RuntimeError`` with the compiler's
    output when ``g++`` fails."""
    src = os.path.join(SRC_DIR, name)
    flags = _flags(extra)
    digest = hashlib.sha256(' '.join(flags).encode())
    with open(src, 'rb') as fh:
        digest.update(fh.read())
    stem = os.path.splitext(name)[0]
    out_dir = build_dir()
    path = os.path.join(out_dir, '%s-%s.so' % (stem, digest.hexdigest()[:16]))
    if os.path.isfile(path):
        return path
    os.makedirs(out_dir, exist_ok=True)
    tmp = '%s.%d.%d.tmp' % (path, os.getpid(), threading.get_ident())
    try:
        proc = subprocess.run(['g++'] + flags + [src, '-o', tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError('g++ failed to build %s:\n%s%s'
                               % (src, proc.stdout, proc.stderr))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load(name: str, setup, python: bool):
    """The library of ``native_src/<name>`` loaded once per process
    (``ctypes.PyDLL`` where it runs CPython API code, so the GIL stays
    held), its signatures set by ``setup(lib)``; None with
    ``KERASLM_NATIVE=0``."""
    if not enabled():
        return None
    key = (name, _sanitized(), build_dir())
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            extra = ('-I' + python_include(),) if python else ()
            path = build(name, extra)
            lib = (ctypes.PyDLL if python else ctypes.CDLL)(path)
            setup(lib)
            _LIBS[key] = lib
    return lib


def _setup_stream_loader(lib):
    lib.build_stream_batches.restype = ctypes.c_int64
    lib.build_stream_batches.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]


def load_library() -> Optional[ctypes.CDLL]:
    """The training batch builder (``stream_loader.cpp``)."""
    return _load('stream_loader.cpp', _setup_stream_loader, python=False)


def _setup_decode_prep(lib):
    lib.decode_scan.restype = ctypes.py_object
    lib.decode_scan.argtypes = [ctypes.py_object, ctypes.c_int,
                                ctypes.c_int, ctypes.c_long]
    lib.decode_fill.restype = ctypes.py_object
    lib.decode_fill.argtypes = [
        ctypes.py_object, ctypes.c_int, ctypes.c_int, ctypes.c_long,
        ctypes.c_long, ctypes.c_long, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float)]
    lib.decode_emit.restype = ctypes.py_object
    lib.decode_emit.argtypes = [
        ctypes.py_object, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_double]


def load_decode_prep():
    """The decode kernels' host prep (``decode_prep.cpp``)."""
    return _load('decode_prep.cpp', _setup_decode_prep, python=True)


_I8 = ctypes.POINTER(ctypes.c_int8)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
_F32 = ctypes.POINTER(ctypes.c_float)
_F64 = ctypes.POINTER(ctypes.c_double)


def _setup_page_scan(lib):
    lib.page_open.restype = ctypes.py_object
    lib.page_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.page_bail.restype = ctypes.py_object
    lib.page_bail.argtypes = [ctypes.py_object]
    lib.page_counts.restype = ctypes.py_object
    lib.page_counts.argtypes = [ctypes.py_object]
    lib.page_joins.restype = ctypes.py_object
    lib.page_joins.argtypes = [ctypes.py_object]
    lib.page_arrays.restype = ctypes.c_int64
    lib.page_arrays.argtypes = [
        ctypes.py_object,
        _I8, _I32, _I8, _I8, _I64, _I64, _I8, _I64, _I32,
        _I32, _F64, _I32, _I64, _I64, _I64, _I64]
    lib.page_lattice.restype = ctypes.py_object
    lib.page_lattice.argtypes = [ctypes.py_object, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int]
    lib.page_fill.restype = ctypes.c_int64
    lib.page_fill.argtypes = [
        ctypes.py_object, _I32, ctypes.c_int64,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        _I32, _F32, _F32, _F32,
        _I8, _I32, _I32, _I32, _I32, _I32, _I32, _I32]
    lib.page_apply.restype = ctypes.py_object
    lib.page_apply.argtypes = [ctypes.py_object, ctypes.c_int, _I64, _F64,
                               ctypes.c_int64, ctypes.c_double]
    lib.page_emit.restype = ctypes.py_object
    lib.page_emit.argtypes = [ctypes.py_object, ctypes.py_object]


def load_page_scan():
    """The PAGE-XML byte scanner (``page_scan.cpp``)."""
    return _load('page_scan.cpp', _setup_page_scan, python=True)


def build_all() -> list:
    """Build the three libraries (each in a thread; ``g++`` runs apart)
    and return ``[(source, library path, seconds)]``."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    def one(item):
        name, python = item
        t0 = time.time()
        path = build(name, ('-I' + python_include(),) if python else ())
        return name, path, time.time() - t0
    items = (('decode_prep.cpp', True), ('page_scan.cpp', True),
             ('stream_loader.cpp', False))
    with ThreadPoolExecutor(len(items)) as pool:
        return list(pool.map(one, items))


def decode_scan(edges: list, merge: bool, merge_max: int, n_alts: int = 4):
    """(prepared edges, longest alternative in chars, at least 1) after
    run merging, over the first ``n_alts`` alternatives of each edge;
    None with ``KERASLM_NATIVE=0``."""
    lib = load_decode_prep()
    if lib is None:
        return None
    return lib.decode_scan(edges, int(merge), merge_max, n_alts)


def decode_fill(edges: list, merge: bool, merge_max: int, E: int, A: int,
                L: int, table: np.ndarray):
    """Fill the (E, A, L) decode arrays; returns (emission meta, chars,
    mask, conf, valid), or None with ``KERASLM_NATIVE=0``.  The meta
    are dicts ``{'alts', 'parts', 'element'}`` as
    ``Rater._prepare_decode_edges`` gives them (without ``alt_ids`` and
    ``alt_conf``)."""
    lib = load_decode_prep()
    if lib is None:
        return None
    table = np.ascontiguousarray(table, np.int32)
    alt_chars = np.zeros((E, A, L), np.int32)
    alt_mask = np.zeros((E, A, L), np.float32)
    alt_conf = np.zeros((E, A, L), np.float32)
    alt_valid = np.zeros((E, A), np.float32)
    meta = lib.decode_fill(
        edges, int(merge), merge_max, E, A, L,
        table.ctypes.data_as(_I32), ctypes.c_int64(len(table)),
        alt_chars.ctypes.data_as(_I32), alt_mask.ctypes.data_as(_F32),
        alt_conf.ctypes.data_as(_F32), alt_valid.ctypes.data_as(_F32))
    return meta, alt_chars, alt_mask, alt_conf, alt_valid


def decode_emit(meta: list, choices, path_costs, start_cost: float):
    """The (element, textequiv, score) path and its entropy from walked
    choices and cumulative costs; None with ``KERASLM_NATIVE=0``."""
    lib = load_decode_prep()
    if lib is None:
        return None
    n = len(meta)
    chs = np.ascontiguousarray(np.asarray(choices[:n]), np.int64)
    costs = np.ascontiguousarray(np.asarray(path_costs[:n]), np.float64)
    if len(chs) < n or len(costs) < n:
        raise ValueError('decode_emit: %d edges, %d choices, %d costs'
                         % (n, len(chs), len(costs)))
    return lib.decode_emit(meta, chs.ctypes.data_as(_I64),
                           costs.ctypes.data_as(_F64), ctypes.c_long(n),
                           ctypes.c_double(start_cost))


def build_stream_batches(ids: np.ndarray, batch: int, length: int):
    """All (x, y, mask) stream windows of one file in one call: x, y
    ``(n_windows, batch, length)`` int32, mask float32; None for a text
    shorter than two ids, or with ``KERASLM_NATIVE=0``."""
    lib = load_library()
    if lib is None:
        return None
    ids = np.ascontiguousarray(ids, np.int32)
    n = len(ids)
    if n < 2:
        return None
    B = max(1, min(batch, (n - 1) // (length + 1)))
    stream_len = (n - 1) // B
    # the last stream absorbs the (n-1) % B remainder, so the window
    # axis takes ITS length; the ceiling includes the masked final window
    last_len = (n - 1) - (B - 1) * stream_len
    max_windows = max(-(-last_len // length), 1)
    x = np.zeros((max_windows, batch, length), np.int32)
    y = np.zeros((max_windows, batch, length), np.int32)
    mask = np.zeros((max_windows, batch, length), np.float32)
    b_used = ctypes.c_int64(0)
    n_w = lib.build_stream_batches(
        ids.ctypes.data_as(_I32), ctypes.c_int64(n), ctypes.c_int64(batch),
        ctypes.c_int64(length), x.ctypes.data_as(_I32),
        y.ctypes.data_as(_I32), mask.ctypes.data_as(_F32),
        ctypes.c_int64(max_windows), ctypes.byref(b_used))
    if n_w <= 0:
        return None
    return x[:n_w], y[:n_w], mask[:n_w]

"""The PyTorch port stands alone: no module of ``ocrd_keraslm_torch``
(nor ``chip_smoke.py``) imports JAX or the JAX package, and the entry
points run on CUDA unless the CPU is asked for."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
PKG = os.path.join(REPO, 'ocrd_keraslm_torch')
FORBIDDEN = ('jax', 'jaxlib', 'ocrd_keraslm_tpu')
# not installed beside PyTorch on the GPU machine: the port reads and
# writes h5 and XML with its own code and the standard library, and
# trains with torch.optim
NOT_ON_CARD = ('h5py', 'lxml', 'optax', 'orbax')


def _sources():
    for root, _, files in os.walk(PKG):
        for name in sorted(files):
            if name.endswith('.py'):
                yield os.path.join(root, name)


def _modules():
    for path in _sources():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, '.')
        yield rel[:-len('.__init__')] if rel.endswith('.__init__') else rel


def _forbidden(name):
    return name.split('.')[0] in FORBIDDEN + NOT_ON_CARD


def test_the_training_slice_is_among_the_checked_modules():
    modules = set(_modules())
    assert {'ocrd_keraslm_torch.training', 'ocrd_keraslm_torch.data',
            'ocrd_keraslm_torch.utils.hdf5', 'ocrd_keraslm_torch.utils.h5io',
            'ocrd_keraslm_torch.ops.lstm_cell'} <= modules


def test_importing_every_module_loads_no_jax_h5py_or_lxml():
    code = ('import importlib, sys\n'
            'for m in %r: importlib.import_module(m)\n'
            'import chip_smoke\n'
            'print(sorted(m for m in sys.modules\n'
            '             if m.split(".")[0] in %r))\n'
            % (sorted(_modules()), FORBIDDEN + NOT_ON_CARD))
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == '[]', proc.stdout


def _docstrings(tree):
    nodes = [tree] + [n for n in ast.walk(tree) if isinstance(
        n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))]
    return {id(n.body[0].value) for n in nodes
            if n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}


@pytest.mark.parametrize('path', sorted(_sources()) + [
    os.path.join(REPO, 'chip_smoke.py')],
    ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_nothing_of_jax(path):
    with open(path, encoding='utf-8') as fh:
        tree = ast.parse(fh.read(), path)
    docs = _docstrings(tree)
    in_package = path.startswith(PKG)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert not any(_forbidden(a.name) for a in node.names), \
                (path, node.lineno)
        elif isinstance(node, ast.ImportFrom):
            assert node.level or not _forbidden(node.module or ''), \
                (path, node.lineno)
        elif in_package and isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and id(node) not in docs:
            # no file path into the JAX package (its native sources
            # included): the port keeps its own copies
            assert 'ocrd_keraslm_tpu' not in node.value, \
                (path, node.lineno, node.value)
            assert 'native_src' not in node.value, (path, node.lineno)


def test_rater_defaults_to_cuda_and_raises_without_it(monkeypatch):
    import torch

    from ocrd_keraslm_torch.rater import Rater, resolve_device
    if torch.cuda.is_available():
        pytest.skip('this check needs a machine without CUDA')
    for value in (None, 'gpu', 'cuda'):
        if value is None:
            monkeypatch.delenv('KERASLM_PLATFORM', raising=False)
        else:
            monkeypatch.setenv('KERASLM_PLATFORM', value)
        with pytest.raises(RuntimeError, match='CUDA'):
            Rater()
    with pytest.raises(RuntimeError, match='CUDA'):
        Rater(device='cuda')
    monkeypatch.setenv('KERASLM_PLATFORM', 'cpu')
    assert Rater().device == torch.device('cpu')
    monkeypatch.setenv('KERASLM_PLATFORM', 'tpu')
    with pytest.raises(ValueError, match='KERASLM_PLATFORM'):
        resolve_device()

"""What the harness loads: never JAX or the JAX package (by whole
top-level names: the port's name begins with the JAX package's), and
the reference nothing of the port."""
import ast
import glob
import os
import subprocess
import sys

from portbench import run

ROOT = run.ROOT
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'ocrd_keraslm_tpu')


def _top_levels(code):
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    loaded = _top_levels(
        'import copy, sys, torch\n'
        'from portbench import run\n'
        'cell = run.Cell(run.Spec(), "german.decode.b10")\n'
        't = copy.deepcopy(cell.traffic)\n'
        't.update(documents=1, pages=1, lines=2)\n'
        't["check"]["sample_pages"] = 1\n'
        'cell.traffic = t\n'
        'run.execute(cell, 3, 0.1, False, device="cpu")\n'
        'print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))')
    assert 'ocrd_keraslm_torch' in loaded
    assert not loaded & set(FORBIDDEN)


def test_forbidden_names_are_whole_top_levels():
    sys.modules.setdefault('ocrd_keraslm_tpu_like', type(sys)('x'))
    try:
        assert run.forbidden_modules() == sorted(
            {m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))
        assert 'ocrd_keraslm_tpu_like' not in run.forbidden_modules()
    finally:
        del sys.modules['ocrd_keraslm_tpu_like']


def test_reference_imports_nothing_of_the_port():
    loaded = _top_levels(
        'import sys\n'
        'import portbench.reference.lm, portbench.reference.decode\n'
        'import portbench.reference.generate, portbench.reference.train\n'
        'import portbench.roofline, portbench.inputs, portbench.trace\n'
        'print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))')
    assert 'ocrd_keraslm_torch' not in loaded
    assert not loaded & set(FORBIDDEN)
    for path in glob.glob(os.path.join(ROOT, 'portbench', 'reference',
                                       '*.py')):
        tree = ast.parse(open(path, encoding='utf-8').read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split('.')[0] not in (
                    'ocrd_keraslm_torch',) + FORBIDDEN, (path, name)


def test_no_result_without_a_card():
    out = subprocess.run(
        [sys.executable, '-m', 'portbench.run', '--workload',
         'german.decode.b10', '--seed', '1', '--seconds', '1'],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert out.returncode != 0
    assert out.stdout.strip() == ''

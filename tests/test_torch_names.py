"""Every public name of the JAX package has its counterpart in the port:
each top-level function and class of a module of ``ocrd_keraslm_tpu/``,
and each public method of such a class, exists under the same name in
the port's module of the same path, or stands in :data:`RENAMED` with
the port's name for it.  Read from the sources with ``ast``; nothing is
imported."""
import ast
import functools
import os

import pytest

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
JAX_PKG = os.path.join(REPO, 'ocrd_keraslm_tpu')
PORT_PKG = os.path.join(REPO, 'ocrd_keraslm_torch')

# 'module:name' of the JAX package -> 'module:name' of its counterpart
RENAMED = {
    # the Pallas kernels' entry points -> the wrappers of the CUDA kernels
    'ops/decode_kernel.py:decode_lattice_pallas':
        'ops/decode_kernel.py:decode_lattice',
    'ops/decode_kernel.py:decode_lattice_pallas_batch':
        'ops/decode_kernel.py:decode_lattice_batch',
    'ops/score_kernel.py:score_scan_pallas': 'ops/score_kernel.py:score_scan',
    'ops/lstm_cell.py:lstm_scan_pallas': 'ops/lstm_cell.py:lstm_scan',
    'ops/gen_kernel.py:generate_pallas': 'ops/gen_kernel.py:gen_beam',
    'ops/gen_kernel.py:generate_pallas_best':
        'ops/gen_kernel.py:generate_best',
    'ops/gen_kernel.py:generate_pallas_variants':
        'ops/gen_kernel.py:generate_variants',
    # a VMEM estimate -> the layouts that fit the card
    'ops/gen_kernel.py:fused_gen_vmem_bytes': 'ops/gen_kernel.py:gen_layouts',
    # NamedSharding helpers -> the placements of parallel/mesh.py
    'parallel/mesh.py:param_shardings': 'parallel/mesh.py:shard_params',
    'parallel/mesh.py:batch_shardings': 'parallel/mesh.py:shard_batch',
    'parallel/mesh.py:carry_sharding': 'parallel/mesh.py:shard_carry',
    'parallel/mesh.py:adam_opt_shardings':
        'parallel/mesh.py:shard_adam_state',
    # the shard-mapped walk -> the batch walk every rank runs on its own
    'parallel/decode.py:make_fused_batch_walk':
        'ops/decode_kernel.py:walk_records_batch',
    'models/lstm_lm.py:lstm_gates': 'ops/lstm_cell.py:lstm_gates',
    'native.py:Prefetcher': 'data.py:Prefetcher',
    'native.py:Prefetcher.close': 'data.py:Prefetcher.close',
}


@functools.lru_cache(maxsize=None)
def public_names(path):
    """Public top-level functions and classes of the module at ``path``,
    and ``Class.method`` for the public methods of its public classes."""
    with open(path, encoding='utf-8') as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    defs = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    for node in tree.body:
        if isinstance(node, defs) and not node.name.startswith('_'):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update('%s.%s' % (node.name, sub.name)
                             for sub in node.body
                             if isinstance(sub, defs[:2])
                             and not sub.name.startswith('_'))
    return names


def modules(pkg):
    return sorted(os.path.relpath(os.path.join(root, name), pkg)
                  .replace(os.sep, '/')
                  for root, _, files in os.walk(pkg) for name in files
                  if name.endswith('.py'))


def port_has(key):
    module, name = key.split(':')
    path = os.path.join(PORT_PKG, module)
    return os.path.isfile(path) and name in public_names(path)


@pytest.mark.parametrize('module', modules(JAX_PKG))
def test_module_names_have_counterparts(module):
    names = public_names(os.path.join(JAX_PKG, module))
    missing = sorted(
        name for name in names
        if not port_has(RENAMED.get('%s:%s' % (module, name),
                                    '%s:%s' % (module, name))))
    assert not missing, (module, missing)


def test_renamed_entries_are_live():
    """Each entry names a public JAX name that the port's module of the
    same path lacks, and a counterpart that exists."""
    for key, target in RENAMED.items():
        module, name = key.split(':')
        assert name in public_names(os.path.join(JAX_PKG, module)), key
        assert not port_has(key), key
        assert port_has(target), (key, target)

"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration (``portbench/configs/<config>.json``) and traffic mix
(``portbench/traffic/<traffic>.json``); the mix's ``kind`` names the
general driver that reads it (``portbench/kinds/<kind>.py``), and each
per-layer metric is read by ``portbench/metrics/<metric>.py``.  A run
sets up (inputs and weights from the seed, the program loaded and every
shape of the cell warmed up: ``setup_s``), measures for ``--seconds``,
reads the peak of device memory, frees the program's state, and checks
what the window produced against the plain reference.  With
``--trace 0`` the last line of standard output is the result with the
cell's end-to-end metrics, with ``--trace 1`` with its per-layer
metrics read from the window's device trace, spans and counters.  The
numbers compared, each beside its limit, end standard error and the
result's line.

Without CUDA, with fewer cards than the cell asks for, or with JAX or
the JAX package loaded once the window has closed, it prints no result
and exits non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'ocrd_keraslm_tpu')


class Refused(Exception):
    """The run cannot give a result (no card, a forbidden module)."""


def load_json(path: str):
    with open(path, encoding='utf-8') as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """A module of the benchmark by file path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    """``BENCHMARK.json`` and the files it names, resolved by name."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.data = load_json(os.path.join(root, 'BENCHMARK.json'))
        self.cells = {w['name']: w for w in self.data['workloads']}
        self.configs = {c['name']: c for c in self.data['configs']}

    def path(self, *parts) -> str:
        return os.path.join(self.root, *parts)

    def config_path(self, config: str) -> str:
        return self.path(self.configs[config]['file'])

    def traffic_path(self, traffic: str) -> str:
        return self.path('portbench', 'traffic', traffic + '.json')

    def kind_path(self, kind: str) -> str:
        return self.path('portbench', 'kinds', kind + '.py')

    def metric_path(self, metric: str) -> str:
        return self.path('portbench', 'metrics', metric + '.py')

    def metrics_of(self, cell: str, which: str) -> List[dict]:
        """The cell's end-to-end ('end_to_end') or per-layer
        ('per_layer') metrics: those listing it, or listing no cells."""
        return [m for m in self.data[which]
                if 'workloads' not in m or cell in m['workloads']]


class Cell:
    """One cell resolved: its entry, configuration, traffic and driver."""

    def __init__(self, spec: Spec, name: str):
        if name not in spec.cells:
            raise KeyError('no workload %r in BENCHMARK.json' % name)
        self.spec = spec
        self.name = name
        self.entry = spec.cells[name]
        self.config = load_json(spec.config_path(self.entry['config']))
        self.traffic = load_json(spec.traffic_path(self.entry['traffic']))
        self.kind = load_module(spec.kind_path(self.traffic['kind']),
                                'portbench_kind_' + self.traffic['kind'])


def card(chips: int) -> dict:
    """The card this run uses, or :class:`Refused`."""
    import torch
    if not torch.cuda.is_available():
        raise Refused('no CUDA device: this benchmark measures the card')
    if torch.cuda.device_count() < chips:
        raise Refused('the cell needs %d cards, %d found'
                      % (chips, torch.cuda.device_count()))
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': chips}


def power_limit() -> Optional[str]:
    import subprocess
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def forbidden_modules() -> List[str]:
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def work_dir() -> str:
    """A fresh directory for the run's inputs and outputs under TMPDIR
    (removed at the end of the run)."""
    import tempfile
    return tempfile.mkdtemp(prefix='portbench-')


# CPU threads of the run's process (OpenMP, BLAS, PyTorch's intra-op
# pool): the card's machine shares its host, and with a thread a core a
# training run lost up to 14% of its rate to the others for its whole
# window (my chip runs: 694,463-810,506 chars/s in 12 runs at the
# default of 8, 805,426 and 806,046 at 2)
CPU_THREADS = '2'


def prepare_env() -> None:
    """Caches of the program inside the checkout, at fixed paths, and
    few CPU threads; before numpy or torch is imported."""
    os.environ.setdefault('KERASLM_NATIVE_DIR', os.path.join(
        ROOT, 'ocrd_keraslm_torch', '_build'))
    os.environ.setdefault('USE_FLAX', '0')
    for var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS',
                'OPENBLAS_NUM_THREADS'):
        os.environ[var] = CPU_THREADS


def join_threads(timeout: float = 10.0) -> None:
    """Wait for the threads the program started (prefetchers) to end."""
    import threading
    for t in threading.enumerate():
        if t is not threading.main_thread():
            t.join(timeout)


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: Optional[str] = None) -> dict:
    """One run of ``cell``; returns the result object.  ``device`` serves
    the benchmark's own CPU tests: another device than the card."""
    import shutil
    import torch
    info = card(cell.entry['chips']) if device is None else {
        'platform': 'cpu', 'kind': 'cpu', 'count': 1}
    dev = device or 'cuda'
    work = work_dir()
    try:
        job = cell.kind.setup(cell, seed, work, dev)
        if dev == 'cuda':
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T_START
        tracer = None
        if trace:
            from .trace import Tracer
            tracer = Tracer()
        cell.kind.window(job, seconds, tracer)
        if getattr(job, 'setup_end', None) is not None:
            # a driver whose set-up ends inside the program's own call
            setup_s = job.setup_end - T_START
        tr = tracer.stop() if tracer is not None else None
        bad = forbidden_modules()
        if bad:
            raise Refused('modules loaded in the run: %s' % ', '.join(bad))
        if dev == 'cuda':
            info['memory_peak_bytes'] = int(torch.cuda.max_memory_allocated())
        else:
            info['memory_peak_bytes'] = 0
        if tr is not None:
            info['busy_s'] = tr.busy_s
            info['window_s'] = tr.window_s
        cell.kind.release(job)
        join_threads()
        numbers = cell.kind.check(job, seed)
        bad = forbidden_modules()
        if bad:
            raise Refused('modules loaded in the run: %s' % ', '.join(bad))
        correct = all(n['value'] <= n['limit'] for n in numbers)
        metrics: Dict[str, dict] = {}
        if not trace:
            values = cell.kind.end_to_end(job)
            values['setup_s'] = setup_s
            for m in cell.spec.metrics_of(cell.name, 'end_to_end'):
                if m['name'] in values:
                    metrics[m['name']] = {'value': values[m['name']],
                                          'unit': m['unit']}
        else:
            job.trace = tr
            for m in cell.spec.metrics_of(cell.name, 'per_layer'):
                reader = load_module(cell.spec.metric_path(m['name']),
                                     'portbench_metric_' + m['name'])
                value = reader.read(job)
                if value is not None:
                    metrics[m['name']] = {'value': value, 'unit': m['unit']}
        result = {'correct': correct, 'attempted': job.attempted,
                  'failed': job.failed, 'metrics': metrics, 'device': info}
        if tr is not None:
            result['breakdown'] = {'device_ops': tr.device_ops(),
                                   'idle_gaps': tr.idle_gaps()}
        result['compared'] = {n['name']: {'value': n['value'],
                                          'limit': n['limit']}
                              for n in numbers}
        job.numbers = numbers
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    prepare_env()
    try:
        cell = Cell(Spec(), args.workload)
        result = execute(cell, args.seed, args.seconds, bool(args.trace))
    except Refused as err:
        print('portbench: %s' % err, file=sys.stderr)
        return 3
    limit = power_limit()
    if limit:
        print('card: %s' % limit, file=sys.stderr)
    for name, n in result['compared'].items():
        print('%s %.6g limit %.6g' % (name, n['value'], n['limit']),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""Readings that a cell's limits are set from, on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--seconds 10] [--control 3] [--fault half_batch_train]

In one process, for each seed: the cell's set-up, a window of
``--seconds`` and its check, printing the numbers compared (the
program's readings, the lower ones); for the first ``--control`` seeds
also the check's numbers of the reference put in the program's place
in bfloat16 (the control, the upper readings); with ``--fault`` the
program runs with that fault of ``faults.py`` planted (one that reaches
the card's path: ``faults.CPU_ONLY`` are refused here).  For the same
seeds as the control, a cell whose driver has ``planted`` also prints
the numbers of the faults planted in the reference put in the program's
place (a narrower search).  Each line is a JSON object.  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import time

from portbench import faults, run


class Patches:
    def __init__(self):
        self.saved = []

    def __call__(self, owner, name, value):
        self.saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)

    def undo(self):
        for owner, name, value in reversed(self.saved):
            setattr(owner, name, value)
        self.saved = []


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--seconds', type=float, default=10.0)
    p.add_argument('--control', type=int, default=0)
    p.add_argument('--fault', default=None)
    args = p.parse_args(argv)
    run.prepare_env()
    cell = run.Cell(run.Spec(), args.workload)
    run.card(cell.entry['chips'])
    patches = Patches()
    if args.fault:
        if args.fault in faults.CPU_ONLY:
            raise SystemExit('%s does not reach the card\'s path'
                             % args.fault)
        getattr(faults, args.fault)(patches)
    for i, seed in enumerate(int(s) for s in args.seeds.split(',')):
        work = run.work_dir()
        try:
            job = cell.kind.setup(cell, seed, work, 'cuda')
            cell.kind.window(job, args.seconds, None)
            e2e = cell.kind.end_to_end(job)
            cell.kind.release(job)
            run.join_threads()
            t0 = time.perf_counter()
            line = {'seed': seed, 'fault': args.fault, 'e2e': e2e,
                    'program': {n['name']: n['value']
                                for n in cell.kind.check(job, seed)}}
            line['check_s'] = time.perf_counter() - t0
            for key in ('left_out', 'diagnostics', 'loss_gap',
                        'search_gaps'):
                if getattr(job, key, None) is not None:
                    line[key] = getattr(job, key)
            if i < args.control:
                line['control'] = {n['name']: n['value']
                                   for n in cell.kind.control(job, seed)}
                if hasattr(cell.kind, 'planted'):
                    line['planted'] = {
                        name: {n['name']: n['value'] for n in numbers}
                        for name, numbers in
                        cell.kind.planted(job, seed).items()}
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps(line), flush=True)
    patches.undo()
    return 0


if __name__ == '__main__':
    sys.exit(main())

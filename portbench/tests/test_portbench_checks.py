"""Tiny CPU rehearsals of each cell's loop and check: a sound run is
correct; the lower-precision control and each fault the cell can have,
planted in the timed path, are not.  The card skips nothing here: these
runs take the CPU in place of the card (``run.execute(device='cpu')``)
and the plain versions of the kernels."""
import copy

import pytest
import torch

from portbench import faults, run

torch.set_num_threads(2)
SPEC = run.Spec()


def tiny(name):
    """The cell ``name`` at a size the CPU runs in seconds."""
    cell = run.Cell(SPEC, name)
    t, c = copy.deepcopy(cell.traffic), copy.deepcopy(cell.config)
    if t['kind'] == 'decode':
        t.update(documents=1, pages=2, lines=3)
        t['check']['sample_pages'] = 2
    elif t['kind'] == 'generate':
        # the cell's own length: shorter strings part from the bfloat16
        # control's too seldom for its test
        t.update(prompt_chars=[6, 12, 18, 24, 30, 36])
    else:
        c.update(width=16, batch=4, length=8)
        t['corpus'].update(train_chars=3000, validation_chars=800)
    cell.traffic, cell.config = t, c
    return cell


def outcome(cell, seed=5):
    res = run.execute(cell, seed, 0.5, False, device='cpu')
    return res['correct'], res['compared']


CELLS = [w['name'] for w in SPEC.data['workloads']]


@pytest.mark.parametrize('name', CELLS)
def test_sound_run_is_correct(name):
    ok, compared = outcome(tiny(name))
    assert ok, compared


@pytest.mark.parametrize('name', CELLS)
def test_control_is_not_correct(name, tmp_path):
    cell = tiny(name)
    job = cell.kind.setup(cell, 5, str(tmp_path), 'cpu')
    cell.kind.window(job, 0.5, None)
    cell.kind.release(job)
    numbers = cell.kind.control(job, 5)
    assert any(n['value'] > n['limit'] for n in numbers), numbers


# -- faults planted underneath the timed path (faults.py) ---------------

FAULTS = [(w['name'], fault) for w in SPEC.data['workloads']
          for fault in faults.FAULTS[run.Cell(SPEC, w['name'])
                                     .traffic['kind']]]


@pytest.mark.parametrize('name,fault', FAULTS,
                         ids=['%s-%s' % (n, f.__name__) for n, f in FAULTS])
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch.setattr)
    ok, compared = outcome(tiny(name))
    assert not ok, compared


# -- narrowed searches planted in the reference put in the program's
# place (a driver's ``planted``) -----------------------------------------

PLANTED = [w['name'] for w in SPEC.data['workloads']
           if hasattr(run.Cell(SPEC, w['name']).kind, 'planted')]


@pytest.mark.parametrize('name', PLANTED)
def test_narrowest_planted_search_is_not_correct(name, tmp_path):
    cell = tiny(name)
    if cell.traffic['kind'] == 'decode':
        # a greedy walk over three lines can find the beam's path
        cell.traffic.update(pages=1, lines=20)
    job = cell.kind.setup(cell, 5, str(tmp_path), 'cpu')
    cell.kind.window(job, 0.5, None)
    cell.kind.release(job)
    planted = cell.kind.planted(job, 5)
    numbers = planted[sorted(planted, key=lambda k: int(k.split('_')[1]))[0]]
    assert any(n['value'] > n['limit'] for n in numbers), numbers

"""The port's trace spans (``utils/devtrace.span``) on the CPU: off, a
span is one shared no-op that never calls into the profiler; under a
CPU ``torch.profiler`` the page loop, the trainer and generation mark
their layer boundaries as ``keraslm.*`` host ranges, nested as the code
nests them and tied to their page, step or request."""
import os
import random

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ocrd_keraslm_torch.training as ttraining
from chip_smoke import build_workspace
from ocrd_keraslm_torch.data import Prefetcher
from ocrd_keraslm_torch.rater import Rater
from ocrd_keraslm_torch.utils import devtrace
from ocrd_keraslm_torch.wrapper import KerasRate
from ocrd_keraslm_torch.wrapper.mets import Workspace

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
GERMAN = os.path.join(REPO, 'pretrained', 'model_german.h5')


@pytest.fixture(scope='module')
def german():
    rater = Rater(device='cpu')
    rater.load_config(GERMAN)
    rater.stateful = False
    rater.incremental = True
    rater.configure()
    rater.load_weights(GERMAN)
    return rater


def traced(fn):
    """Run ``fn`` under a CPU profiler that records shapes (so spans keep
    their unit); returns its result and the recorded ``keraslm.*``
    spans as (name without the prefix, start us, end us, unit), in start
    order."""
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        out = fn()
    spans = [(e.name[len(devtrace.PREFIX):], e.time_range.start,
              e.time_range.end, (getattr(e, 'kwinputs', None) or {}).get(
                  'unit')) for e in prof.events()
             if e.name.startswith(devtrace.PREFIX)]
    return out, sorted(spans, key=lambda s: s[1])


def named(spans, name):
    return [s for s in spans if s[0] == name]


def within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_off_is_one_shared_no_op(german, monkeypatch):
    """Without a profiler no span reaches the profiler: both ways of
    opening a range raise here, and generation, the data thread and a
    span of each form still run."""
    def boom(*a, **kw):
        raise AssertionError('a span called into the profiler')
    monkeypatch.setattr(torch.profiler, 'record_function', boom)
    monkeypatch.setattr(devtrace, '_RANGE', boom)
    assert devtrace.span('rate.workspace') is devtrace._OFF
    assert devtrace.span('rate.finish', 'page=p1') is devtrace._OFF
    with devtrace.span('train.step', 'step=1'):
        pass
    assert list(Prefetcher(iter(range(5)))) == list(range(5))
    assert german.generate('Die Ver', 6, variants=2)


def test_page_loop_spans(german, tmp_path):
    """One ``rate.workspace`` holding every span of the pass: a
    ``rate.finish`` for each page written, with its page id, the
    launches, the loads and the METS save."""
    directory = str(tmp_path / 'ws')
    build_workspace(directory, np.random.default_rng(3), 3, 2,
                    german.vocab)
    proc = KerasRate(parameter={'model_file': GERMAN}, device='cpu')
    proc.setup()
    _, spans = traced(lambda: proc.process_workspace(Workspace(directory)))
    written = sorted(f.pageId for f in Workspace(directory).mets.find_files(
        fileGrp='OCR-D-LM'))
    assert written == ['phys_0001', 'phys_0002', 'phys_0003']
    ws, = named(spans, 'rate.workspace')
    finishes = named(spans, 'rate.finish')
    assert sorted(u for _, _, _, u in finishes) == [
        'page=' + p for p in written]
    assert named(spans, 'rate.launch')
    assert named(spans, 'rate.mets_save')
    waits = named(spans, 'rate.load_wait')
    assert sorted(u for _, _, _, u in waits) == [
        'page=' + p for p in written]
    for s in spans:
        if s is not ws:
            assert within(s, ws), s
    # the loads run in the prefetch thread, which this profiler does not
    # record; the main thread waits for them
    assert not named(spans, 'rate.load')


def test_trainer_spans(tmp_path, monkeypatch):
    """A ``train.step`` for every step run, the data thread's waits and
    a ``train.validate`` and a best-only ``train.checkpoint`` an epoch."""
    random.seed(7)
    words = ['die', 'der', 'und', 'ist', 'kant', 'vernunft', 'mensch']
    files = []
    for name in ('a_eins_1781.txt', 'b_zwei_1790.txt'):
        path = tmp_path / name
        path.write_text('\n'.join(' '.join(random.choices(words, k=10))
                                  for _ in range(40)) + '\n')
        files.append(str(path))
    steps = []
    step = ttraining.train_step

    def counted(*a, **kw):
        steps.append(1)
        return step(*a, **kw)
    monkeypatch.setattr(ttraining, 'train_step', counted)
    monkeypatch.setattr(ttraining, 'EPOCHS', 2)
    np_state, py_state = np.random.get_state(), random.getstate()
    np.random.seed(3)
    try:
        rater = Rater(device='cpu')
        rater.width, rater.depth, rater.length = 16, 1, 16
        rater.batch_size = 4
        rater.ckpt_dir = str(tmp_path / 'ckpt')
        rater.configure()
        _, spans = traced(lambda: rater.train(files))
    finally:
        np.random.set_state(np_state)
        random.setstate(py_state)
    assert rater.status == 2
    assert len(steps) > 2
    assert [u for _, _, _, u in named(spans, 'train.step')] == [
        'step=%d' % (i + 1) for i in range(len(steps))]
    assert len(named(spans, 'data.wait')) >= len(steps)
    assert [u for _, _, _, u in named(spans, 'train.validate')] == [
        'epoch=1', 'epoch=2']
    assert named(spans, 'train.checkpoint')
    assert not named(spans, 'data.batch')   # the data thread's own


def test_generation_spans(german):
    """``gen.request`` holds the prompt's steps and the strings."""
    out, spans = traced(lambda: german.generate('Die Vernunft ', 8,
                                                variants=3))
    assert len(out) == 3
    request, = named(spans, 'gen.request')
    assert request[3].startswith('request=')
    prompt, = named(spans, 'gen.prompt')
    strings, = named(spans, 'gen.strings')
    assert within(prompt, request) and within(strings, request)
    assert prompt[2] <= strings[1]
    # on the CPU the result is its own host copy: nothing to wait for
    assert not named(spans, 'fetch')


def test_cli_trace_records_every_thread(german, tmp_path):
    """``devtrace.start_trace`` (``--jax-trace``) records the worker
    threads' spans too: the prefetch thread's ``rate.load`` and the data
    thread's ``data.batch``, each on a thread of its own."""
    import json

    directory = str(tmp_path / 'ws')
    build_workspace(directory, np.random.default_rng(5), 3, 2,
                    german.vocab)
    proc = KerasRate(parameter={'model_file': GERMAN}, device='cpu')
    proc.setup()
    stop = devtrace.start_trace(str(tmp_path / 'trace'))
    try:
        proc.process_workspace(Workspace(directory))
        assert list(Prefetcher(iter(range(3)))) == [0, 1, 2]
    finally:
        path = stop()
    with open(path, encoding='utf-8') as fh:
        events = json.load(fh)['traceEvents']
    tids = {}
    for e in events:
        if e.get('name', '').startswith(devtrace.PREFIX):
            tids.setdefault(e['name'], set()).add(e['tid'])
    main, = tids['keraslm.rate.workspace']
    assert len([1 for e in events if e.get('name') == 'keraslm.rate.load']
               ) == 3
    assert main not in tids['keraslm.rate.load']
    assert main not in tids['keraslm.data.batch']
    assert tids['keraslm.data.wait'] == {main}

"""The readers of the program's spans on hand-made traces: each value
against a hand count, spans cut at the window's edges, and None on a
trace without the program's spans (what a program before the spans
gives)."""
import types

import pytest

from portbench import run

SPEC = run.Spec()
MS = 1_000_000   # ns


def reader(name):
    return run.load_module(SPEC.metric_path(name), 'span_metric')


def trace(host, t0=0, t1=1000 * MS):
    """A window from t0 to t1 (ns) holding the host ranges ``host``:
    (start ms, end ms, name without ``keraslm.``); a name with a colon
    is taken as it stands (an operation of PyTorch's)."""
    return types.SimpleNamespace(t0=t0, t1=t1, host=[
        (int(s * MS), int(e * MS), n if ':' in n else 'keraslm.' + n)
        for s, e, n in host])


def job(host, **counts):
    return types.SimpleNamespace(trace=trace(host), **counts)


# two document passes; the first runs over the window's start (-10 ms)
DECODE = [
    (-10, 300, 'rate.workspace'),
    (-5, 20, 'rate.load_wait'),
    (30, 50, 'rate.launch'),
    (100, 160, 'fetch'),
    (200, 260, 'fetch'),
    (400, 900, 'rate.workspace'),
    (405, 415, 'rate.load_wait'),
    (420, 440, 'rate.launch'),
    (450, 470, 'rate.launch'),
    (500, 700, 'fetch'),
    (750, 850, 'fetch'),
    (760, 770, 'aten::zeros'),
]
TRAIN = [(0, 10, 'data.wait'), (10, 22, 'train.step'), (22, 25, 'data.wait'),
         (25, 37, 'train.step'), (990, 1010, 'train.step'),
         (995, 1005, 'data.wait')]
GEN = [(0, 90, 'gen.request'), (1, 9, 'gen.prompt'), (20, 80, 'fetch'),
       (100, 190, 'gen.request'), (101, 105, 'gen.prompt'),
       (120, 185, 'fetch'), (195, 199, 'fetch')]


def test_page_loop_busy():
    # the first pass from 0: 300 - 20 (load) - 60 - 60 (fetches);
    # the second 500 - 10 - 200 - 100
    got = reader('page_loop.busy_ms_per_page').read(job(DECODE, pages=4))
    assert got == pytest.approx((160 + 190) / 4)


def test_page_loop_wait():
    got = reader('page_loop.wait_ms_per_page').read(job(DECODE, pages=4))
    assert got == pytest.approx((60 + 60 + 200 + 100) / 4)


def test_page_loop_pass_edge():
    # only the second pass lies wholly in the window: (440 - 400) from
    # its start to its first launch's end, (900 - 850) after its last
    # fetch
    got = reader('page_loop.pass_edge_ms').read(job(DECODE, pages=4))
    assert got == pytest.approx(40 + 50)


def test_page_loop_pass_edge_needs_a_whole_pass():
    host = [r for r in DECODE if r[0] < 400]
    assert reader('page_loop.pass_edge_ms').read(job(host, pages=2)) is None


def test_train_data_wait():
    # the last wait ends 5 ms past the window (1000 ms)
    got = reader('train.data_wait_ms_per_step').read(
        job(TRAIN, train_steps=3))
    assert got == pytest.approx((10 + 3 + 5) / 3)


def test_train_host():
    got = reader('train.host_ms_per_step').read(job(TRAIN, train_steps=3))
    assert got == pytest.approx((12 + 12 + 10) / 3)


def test_gen_prompt():
    got = reader('gen.prompt_ms_per_request').read(
        job(GEN, requests=[0, 1]))
    assert got == pytest.approx((8 + 4) / 2)


def test_gen_busy():
    # the fetch at 195-199 lies outside every request and is not taken
    got = reader('gen.busy_ms_per_request').read(job(GEN, requests=[0, 1]))
    assert got == pytest.approx((90 - 60 + 90 - 65) / 2)


def test_gen_busy_cut_at_the_window():
    j = job(GEN, requests=[0, 1])
    j.trace.t0, j.trace.t1 = 50 * MS, 150 * MS
    # request 1: 50-90 less fetch 50-80; request 2: 100-150 less 120-150
    got = reader('gen.busy_ms_per_request').read(j)
    assert got == pytest.approx((10 + 20) / 2)


SPAN_METRICS = {
    'page_loop.busy_ms_per_page': dict(pages=4),
    'page_loop.wait_ms_per_page': dict(pages=4),
    'page_loop.pass_edge_ms': dict(pages=4),
    'train.data_wait_ms_per_step': dict(train_steps=3),
    'train.host_ms_per_step': dict(train_steps=3),
    'gen.prompt_ms_per_request': dict(requests=[0, 1]),
    'gen.busy_ms_per_request': dict(requests=[0, 1]),
}


@pytest.mark.parametrize('name', sorted(SPAN_METRICS))
def test_none_without_the_programs_spans(name):
    """A trace of PyTorch's operations alone, as the parent's program
    gives, and no trace at all."""
    ops = [(0, 10, 'aten::mm'), (20, 30, 'cudaLaunchKernel:x'),
           (40, 45, 'rater.rate_best_device_finish_group:x')]
    read = reader(name).read
    assert read(job(ops, **SPAN_METRICS[name])) is None
    assert read(types.SimpleNamespace(trace=None,
                                      **SPAN_METRICS[name])) is None


@pytest.mark.parametrize('name', sorted(SPAN_METRICS))
def test_entry(name):
    """Each reader has its entry: a program span of one cell, in ms."""
    entry, = [m for m in SPEC.data['per_layer'] if m['name'] == name]
    assert entry['source'] == 'program_span' and entry['unit'] == 'ms'
    assert len(entry['workloads']) == 1

"""The slice as a whole: generation in the port against the JAX package
on the CPU, both on the weights of ``pretrained/model_german.h5``.

``Rater.generate``, ``generate_begin``/``generate_finish``,
``generate_batch`` and ``generate_batch_begin``/``_finish`` of the port
(the plain version of the beam-step kernel on the CPU) return the same
strings, in the same order, as the JAX ``Rater``: with its default
engine on the CPU (the XLA scan) and with ``fused_generate='force'``
(its Pallas kernel in interpret mode).  Also the host engine
(``_generate_host``), the fall-back to it when the device fringe dies,
and ``keraslm-rate generate``.  Strings are compared exactly: parity is
held on trained weights only (``gen_kernel.py:42-48`` of the JAX
package)."""
import functools

import pytest
import torch
from click.testing import CliRunner

from ocrd_keraslm_tpu.rater import Rater as JRater
from ocrd_keraslm_tpu.scripts.run import cli as jcli
from ocrd_keraslm_torch.ops import beam_device as tbd
from ocrd_keraslm_torch.rater import Rater
from ocrd_keraslm_torch.scripts.run import cli as tcli

from test_torch_parallel import one_rank_mesh
from test_torch_scoring import GERMAN

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

LONG = ('Was ist Aufklärung? Aufklärung ist der Ausgang des Menschen aus '
        'seiner selbstverschuldeten ')


@pytest.fixture(scope='module')
def raters():
    jr = JRater()
    tr = Rater(device='cpu')
    for r in (jr, tr):
        r.load_config(GERMAN)
        r.configure()
        r.load_weights(GERMAN)
    return jr, tr


def _jax_both(jr, *args, **kwargs):
    """The JAX rater's result with its default engine and with its fused
    kernel; both must agree."""
    jr.fused_generate = True
    xla = jr.generate(*args, **kwargs)
    jr.fused_generate = 'force'
    try:
        fused = jr.generate(*args, **kwargs)
    finally:
        jr.fused_generate = True
    assert xla == fused
    return xla


@pytest.mark.parametrize('prefix, length, variants, context', [
    ('Die Vernunft ', 12, 1, None),
    ('Die Vernunft ', 12, 3, None),
    (LONG, 10, 1, None),
    ('Was ist ', 14, 3, [179])],
    ids=['one', 'three', 'long-prefix', 'context'])
def test_generate_matches_jax(raters, prefix, length, variants, context):
    jr, tr = raters
    assert len(LONG) > 64
    want = _jax_both(jr, prefix, length, context, variants)
    got = tr.generate(prefix, length, context, variants)
    assert got == want
    assert len(got) == variants and all(len(s) == length + 1 for s in got)


def test_generate_zero_variants_is_empty(raters):
    jr, tr = raters
    assert tr.generate('Die ', 4, variants=0) == [] == \
        _jax_both(jr, 'Die ', 4, variants=0)


def test_generate_begin_finish_matches_sync(raters):
    """Two requests in flight, finished in the other order, give what
    the synchronous calls give; an empty prompt takes the host engine
    in both packages."""
    jr, tr = raters
    p1 = tr.generate_begin('Der Mensch ', 8)
    p2 = tr.generate_begin('Die Natur ', 8, variants=2)
    p3 = tr.generate_begin('', 5)
    assert tr.generate_finish(p2) == tr.generate('Die Natur ', 8,
                                                 variants=2)
    assert tr.generate_finish(p1) == jr.generate('Der Mensch ', 8)
    assert tr.generate_finish(p3) == jr.generate('', 5)


def test_generate_batch_matches_jax(raters):
    jr, tr = raters
    prompts = ['Die Vernunft ', 'Was ist ', LONG]
    want = jr.generate_batch(prompts, 12)
    assert tr.generate_batch(prompts, 12) == want
    assert want == [tr.generate(p, 12)[0] for p in prompts]
    # split, two batches in flight, finished in the other order
    b1 = tr.generate_batch_begin(prompts[:2], 12)
    b2 = tr.generate_batch_begin(prompts[2:], 12, [179])
    assert tr.generate_batch_finish(b2) == jr.generate_batch(
        prompts[2:], 12, [179])
    assert tr.generate_batch_finish(b1) == want[:2]
    assert tr.generate_batch_finish(tr.generate_batch_begin([], 12)) == []
    # an empty prompt sends the whole batch to the host engine
    assert tr.generate_batch(['', 'Der '], 6) == jr.generate_batch(
        ['', 'Der '], 6)


def test_generate_host_matches_jax(raters):
    jr, tr = raters
    for args in (('Die Vernunft ', 12, None, 3), ('Was ist ', 8, [179], 2),
                 ('', 6, None, 1)):
        assert tr._generate_host(*args) == jr._generate_host(*args)
    tr.device_beam = False
    try:
        assert tr.generate('Die Vernunft ', 12, None, 3) == \
            jr._generate_host('Die Vernunft ', 12, None, 3)
    finally:
        tr.device_beam = True


def test_dead_device_fringe_falls_back_to_the_host(raters, monkeypatch):
    """A device search whose fringe dies (here: an absolute threshold of
    0.999 kills every candidate at the first step) returns nothing, and
    ``generate`` and ``generate_batch`` then return the host engine's
    strings, as the JAX package does."""
    jr, tr = raters
    for name in ('generate_variants', 'generate_best'):
        monkeypatch.setattr(tbd, name, functools.partial(
            getattr(tbd, name), threshold=0.999))
    assert tbd.generate_beam(tr, 'Die ', 8, None, 2) == []
    assert tbd.generate_streams(tr, ['Die ', 'Der '], 8) == ['', '']
    host = jr._generate_host('Die ', 8, None, 2)
    assert host and tr.generate('Die ', 8, None, 2) == host
    assert tr.generate_batch(['Die ', 'Der '], 8) == [
        jr._generate_host(p, 8)[0] for p in ('Die ', 'Der ')]


def test_mesh_generation_raises(raters):
    """Generation over a mesh of one rank (the id is the one it had
    while the mesh raised): the streams go through the sharded path
    (``parallel/generate.py``: padded to the data axis, gathered) and
    come back as without one, stream for stream."""
    _, tr = raters
    prompts = ['Die ', 'Der Mensch ', 'Kant']
    want = tr.generate_batch(prompts, 4)
    with one_rank_mesh() as mesh:
        tr.mesh = mesh
        try:
            got = tr.generate_batch(prompts, 4)
        finally:
            tr.mesh = None
    assert got == want and all(got)


def test_keraslm_rate_generate_matches_jax(monkeypatch):
    monkeypatch.setenv('KERASLM_PLATFORM', 'cpu')
    outs = []
    for cli in (jcli, tcli):
        res = CliRunner().invoke(cli, ['-l', 'WARNING', 'generate', '-m',
                                       GERMAN, '-n', '12', '-v', '3', '-c',
                                       '1784', 'Die Vernunft '])
        assert res.exit_code == 0, (res.output, res.exception)
        outs.append(res.output.strip().splitlines()[-3:])
    assert outs[1] == outs[0]
    assert all(line.startswith('Die Vernunft ') for line in outs[1])

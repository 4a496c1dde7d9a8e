"""The ``keraslm-rate`` tooling of the port against the JAX package's:
``print-charset`` prints what JAX prints; ``prune-charset`` writes the
weights and mapping JAX writes, bit for bit, and the pruned model
scores as JAX's does (within the scoring tests' RTOL); the three plots
draw JAX's images; ``_spread_labels`` agrees within 1e-12; the prose
generator gives JAX's strings; ``--jax-trace`` writes a Chrome trace
with ``traceEvents`` from both CLIs; the reference's ``lib`` module
path; and no module of the port imports matplotlib, scikit-learn or
the OCR-D core when it is imported."""
import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from ocrd_keraslm_tpu import rater as jrater_mod
from ocrd_keraslm_tpu.scripts.run import cli as jcli
from ocrd_keraslm_tpu.utils import h5io as jh5
from ocrd_keraslm_tpu.utils import textgen as jtextgen
from ocrd_keraslm_tpu.utils.vocab import Vocab as JVocab
from ocrd_keraslm_torch import rater as trater_mod
from ocrd_keraslm_torch.scripts.run import cli as tcli
from ocrd_keraslm_torch.utils import textgen as ttextgen
from ocrd_keraslm_torch.utils.vocab import Vocab as TVocab
from ocrd_keraslm_torch.wrapper import cli as twcli

from helpers import build_workspace

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
GERMAN = os.path.join(REPO, 'pretrained', 'model_german.h5')
RTOL = 1e-4        # as tests/test_torch_scoring.py
PROB_ATOL = 1e-3
TEXT = 'Die Vernunft ist das Vermögen der Prinzipien, sagt Kant.'


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv('KERASLM_PLATFORM', 'cpu')


def _invoke(cli, args):
    res = CliRunner().invoke(cli, args)
    assert res.exit_code == 0, (res.output, res.exception)
    return res.output


def test_print_charset_equals_jax(cpu):
    outs = [_invoke(cli, ['-l', 'WARNING', 'print-charset', '-m', GERMAN])
            for cli in (jcli, tcli)]
    assert outs[1] == outs[0]
    assert outs[0].startswith('1: "\n"\n2: " "') and \
        outs[0].endswith('\n69: "ü"\n')


@pytest.fixture(scope='module')
def pruned(tmp_path_factory):
    """german model with 'J' pruned by each package's CLI: {name:
    path}."""
    d = tmp_path_factory.mktemp('pruned')
    out = {}
    old = os.environ.get('KERASLM_PLATFORM')
    os.environ['KERASLM_PLATFORM'] = 'cpu'
    try:
        for name, cli in (('jax', jcli), ('port', tcli)):
            path = str(d / (name + '.h5'))
            shutil.copy(GERMAN, path)
            _invoke(cli, ['-l', 'WARNING', 'prune-charset', '-m', path, 'J'])
            out[name] = path
    finally:
        if old is None:
            del os.environ['KERASLM_PLATFORM']
        else:
            os.environ['KERASLM_PLATFORM'] = old
    return out


def test_prune_charset_writes_jax_weights_and_mapping(pruned):
    (jp, jcfg, jvocab, jhist), (tp, tcfg, tvocab, thist) = (
        jh5.load_model(pruned[name]) for name in ('jax', 'port'))
    assert tvocab.c2i == jvocab.c2i and 'J' not in tvocab.c2i
    assert tvocab.size == jvocab.size == 69
    assert tcfg == jcfg and thist == jhist
    leaves = [(a, b) for a, b in zip(
        [tp['char_embedding']] + list(tp['context_embeddings']),
        [jp['char_embedding']] + list(jp['context_embeddings']))]
    leaves += [(tl[k], jl[k]) for tl, jl in zip(tp['lstm'], jp['lstm'])
               for k in ('kernel', 'recurrent', 'bias')]
    for a, b in leaves:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tp['char_embedding'].shape[0] == 69


def test_pruned_model_scores_as_jax(pruned):
    jr = jrater_mod.Rater()
    jr.load_config(pruned['jax'])
    jr.configure()
    jr.load_weights(pruned['jax'])
    tr = trater_mod.Rater(device='cpu')
    tr.load_config(pruned['port'])
    tr.configure()
    tr.load_weights(pruned['port'])
    assert tr.voc_size == 69
    (got, g_ppl), (want, w_ppl) = tr.rate2(TEXT, [179]), \
        jr.rate2(TEXT, [179])
    assert g_ppl == pytest.approx(w_ppl, rel=RTOL)
    assert [c for c, _ in got] == [c for c, _ in want]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want],
                               atol=PROB_ATOL)


def test_remove_from_mapping_of_an_unmapped_char(cpu):
    r = trater_mod.Rater()
    r.load_config(GERMAN)
    r.configure()
    r.load_weights(GERMAN)
    emb = r.params['char_embedding']
    assert not r.remove_from_mapping(char='Q')
    assert r.params['char_embedding'] is emb and r.voc_size == 70
    assert r.remove_from_mapping(idx=69)        # 'ü', the last
    assert r.voc_size == 69 and 'ü' not in r.vocab.c2i
    assert torch.equal(r.params['char_embedding'], emb[:69])
    with pytest.raises(RuntimeError, match='loaded weights'):
        fresh = trater_mod.Rater()
        fresh.remove_from_mapping(char='a')


@pytest.mark.parametrize('char, idx', [
    ('b', None), (None, 2), ('z', None), (None, 9), ('?', None),
    (None, None)])
def test_vocab_remove_decode_char_equal_jax(char, idx):
    codepoints = [0, ord('a'), ord('b'), 0, ord('c'), ord('x'), ord('y'),
                  ord('z')]
    jv, tv = JVocab.from_codepoints(codepoints), \
        TVocab.from_codepoints(codepoints)
    assert tv.remove(char, idx) == jv.remove(char, idx)
    assert (tv.c2i, tv.i2c) == (jv.c2i, jv.i2c)
    ids = list(range(-1, 9))
    assert tv.decode(ids) == jv.decode(ids)
    assert [tv.char(i) for i in ids] == [jv.char(i) for i in ids]
    assert list(tv.encode('abcxyz?')) == list(jv.encode('abcxyz?'))


def test_print_charset_warns_about_unnormalised_entries(capsys, caplog):
    v = TVocab.from_codepoints([0, ord('a'), 0x41, 0x30A])  # A + ring
    v.print_charset()
    assert capsys.readouterr().out.splitlines() == [
        '1: "a"', '2: "A"', '3: "̊"']
    jv = JVocab.from_codepoints([0, 0x41, 0x30A, 0xC5])
    tv = TVocab.from_codepoints([0, 0x41, 0x30A, 0xC5])
    jv.print_charset()
    want = capsys.readouterr().out
    tv.print_charset()
    assert capsys.readouterr().out == want


@pytest.mark.parametrize('command, n', [
    ('plot-char-embeddings-similarity', None),
    ('plot-context-embeddings-similarity', 1),
    ('plot-context-embeddings-projection', 1)])
def test_plots_equal_jax(tmp_path, cpu, command, n):
    import matplotlib
    matplotlib.use('Agg')
    from matplotlib import pyplot as plt
    images = []
    for name, cli in (('jax', jcli), ('port', tcli)):
        path = str(tmp_path / (name + '.png'))
        _invoke(cli, ['-l', 'WARNING', command, '-m', GERMAN, path]
                + (['-n', str(n)] if n else []))
        plt.close('all')
        images.append(plt.imread(path))
    assert images[0].shape == images[1].shape and images[0].size > 0
    np.testing.assert_array_equal(images[1], images[0])


def test_plot_without_matplotlib_names_the_extra(tmp_path, cpu,
                                                 monkeypatch):
    r = trater_mod.Rater()
    r.load_config(GERMAN)
    r.configure()
    r.load_weights(GERMAN)
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with pytest.raises(ImportError, match='plotting'):
        r.plot_char_embeddings_similarity(str(tmp_path / 'x.png'))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_spread_labels_equal_jax(seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(40, 2))
    pts[5] = pts[6] = pts[7]               # coincident labels
    pts[10] = pts[11] + 1e-4
    got = trater_mod._spread_labels(pts)
    want = jrater_mod._spread_labels(pts)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert not np.array_equal(got, pts)
    for one in (pts[:1], pts[:0]):
        np.testing.assert_array_equal(trater_mod._spread_labels(one), one)


@pytest.mark.parametrize('n, seed', [(2000, 0), (5000, 7), (300, 123)])
def test_textgen_equals_jax(n, seed):
    assert ttextgen.generate(n, seed=seed) == jtextgen.generate(n, seed=seed)


def test_textgen_corpus_equals_jax(tmp_path):
    paths = {name: mod.write_corpus(str(tmp_path / name), 6000, seed=3)
             for name, mod in (('jax', jtextgen), ('port', ttextgen))}
    assert [os.path.basename(p) for p in paths['port']] == \
        [os.path.basename(p) for p in paths['jax']]
    for a, b in zip(paths['port'], paths['jax']):
        with open(a, encoding='utf-8') as fa, open(b, encoding='utf-8') as fb:
            assert fa.read() == fb.read()


def _trace_events(directory):
    files = glob.glob(os.path.join(directory, '*.pt.trace.json'))
    assert len(files) == 1, files
    with open(files[0]) as fh:
        return json.load(fh)['traceEvents']


def test_jax_trace_writes_a_chrome_trace(tmp_path, cpu):
    """``--jax-trace DIR`` of both CLIs: a torch.profiler trace of the
    command, written when it ends (on the CPU: host events)."""
    (tmp_path / 'kant_werk_1784.txt').write_text(TEXT, encoding='utf-8')
    out = _invoke(tcli, ['-l', 'WARNING', '--jax-trace',
                         str(tmp_path / 'trace'), 'test', '-m', GERMAN,
                         str(tmp_path / 'kant_werk_1784.txt')])
    assert float(out.strip().splitlines()[-1]) > 1.0
    events = _trace_events(tmp_path / 'trace')
    assert any('aten::' in e.get('name', '') for e in events)
    ws = str(tmp_path / 'ws')
    build_workspace(ws, {'p1': [['die', 'vernunft']]})
    _invoke(twcli.ocrd_keraslm_rate, [
        '-m', ws, '--jax-trace', str(tmp_path / 'trace2'), '-P',
        'model_file', GERMAN, '-P', 'textequiv_level', 'word', '-l',
        'WARNING'])
    assert _trace_events(tmp_path / 'trace2')
    assert os.path.isdir(os.path.join(ws, 'OCR-D-LM'))


def test_lib_module_path():
    from ocrd_keraslm_torch import lib
    from ocrd_keraslm_torch.beam import Node
    from ocrd_keraslm_torch.lib import rating
    assert lib.Rater is rating.Rater is trater_mod.Rater
    assert lib.Node is rating.Node is Node


def test_no_optional_package_is_imported_with_the_port():
    """matplotlib, scikit-learn and the OCR-D core are imported where
    they are used (the plots, the adapter), never with a module: the
    card's machine has none of them."""
    import ocrd_keraslm_torch
    pkg = os.path.dirname(ocrd_keraslm_torch.__file__)
    mods = []
    for root, _, files in os.walk(pkg):
        for name in sorted(files):
            if name.endswith('.py'):
                rel = os.path.relpath(os.path.join(root, name), REPO)[:-3]
                mod = rel.replace(os.sep, '.')
                mods.append(mod[:-len('.__init__')]
                            if mod.endswith('.__init__') else mod)
    code = ('import importlib, sys\n'
            'for m in %r: importlib.import_module(m)\n'
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("matplotlib", "sklearn", "ocrd", "ocrd_models")))\n' % mods)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == '[]'
    assert 'ocrd_keraslm_torch.wrapper.ocrd_adapter' in mods
    assert 'ocrd_keraslm_torch.utils.orbaxio' in mods

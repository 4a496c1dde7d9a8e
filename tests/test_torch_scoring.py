"""The slice as a whole: scoring in the port against the JAX package on
the CPU.

``Rater.rate``/``rate2``/``rate_batch``/``test`` of both packages hold
the same weights (seeded numpy) and score the same texts: the layered
path on both sides (JAX with and without its Pallas LSTM scan), and the
fused path (JAX: ``score_scan_pallas`` in interpret mode; port: the
plain version of the ``score_scan`` kernel).  ``SCORE_CHUNK``,
``CHUNK_COUNT_BUCKETS`` and ``SCORE_SPLIT_LIMIT`` are set small in BOTH
packages, so several chunks, super-block chaining and the batch split
run in seconds.  Then the processor in scoring mode on
``model_german.h5`` against the JAX processor, and ``keraslm-rate
apply``/``test`` against the JAX CLI.

Tolerances: per-char probs travel as float16 in both packages, and one
float16 step below 1 is at most 4.9e-4, so probs and confs allow atol
1e-3 (one rounding flip); NLL sums and perplexities rtol 1e-4 (f32);
the carry atol 1e-5."""
import json
import logging
import os
import re

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import jax.numpy as jnp

from ocrd_keraslm_tpu import rater as jrm
from ocrd_keraslm_tpu.models.lstm_lm import LMConfig as JCfg
from ocrd_keraslm_tpu.scripts.run import cli as jcli
from ocrd_keraslm_tpu.wrapper import KerasRate as JKerasRate
from ocrd_keraslm_tpu.wrapper import rate as jrate
from ocrd_keraslm_tpu.wrapper.mets import Workspace
from ocrd_keraslm_tpu.wrapper.page import parse_page
from ocrd_keraslm_torch import rater as trm
from ocrd_keraslm_torch.models.lstm_lm import params_from_numpy
from ocrd_keraslm_torch.scripts.run import cli as tcli
from ocrd_keraslm_torch.wrapper import KerasRate as TKerasRate
from ocrd_keraslm_torch.wrapper import rate as trate
from ocrd_keraslm_torch.wrapper.page import parse_page as tparse_page

from helpers import build_workspace
from test_quality import _corpus_pages
from test_torch_lstm_scan import _params

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
GERMAN = os.path.join(REPO, 'pretrained', 'model_german.h5')
CHARS = 'abcdefghijk '
PROB_ATOL = 1e-3
RTOL = 1e-4


def _raters(stateful=True, length=16, seed=3):
    """A JAX ``Rater`` and the port's CPU ``Rater`` holding the same
    seeded weights (W=32, D=2, one 20x4 context)."""
    jr = jrm.Rater()
    tr = trm.Rater(device='cpu')
    cfg = JCfg(width=32, depth=2, voc_size=len(CHARS) + 1,
               contexts=((20, 4),))
    tree = _params(cfg, seed)
    for r in (jr, tr):
        r.width, r.depth, r.length = 32, 2, length
        r.contexts = ((20, 4),)
        r.stateful = stateful
        r.variable_length = False
        r.vocab.c2i = {c: i for i, c in enumerate(CHARS, 1)}
        r.vocab.i2c = {i: c for i, c in enumerate(CHARS, 1)}
        r.voc_size = r.vocab.size
        r.configure()
        r.status = 2
    jr.params = {'char_embedding': jnp.asarray(tree['char_embedding']),
                 'context_embeddings': [jnp.asarray(e) for e in
                                        tree['context_embeddings']],
                 'lstm': [{k: jnp.asarray(v) for k, v in lp.items()}
                          for lp in tree['lstm']]}
    tr.params = params_from_numpy(tree, 'cpu')
    return jr, tr


def _texts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [''.join(CHARS[i] for i in rng.integers(0, len(CHARS), n))
            for n in lengths]


def _small(monkeypatch, **values):
    for name, value in values.items():
        monkeypatch.setattr(jrm, name, value)
        monkeypatch.setattr(trm, name, value)


def _close_ratings(got, want):
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)


def _check_api(jr, tr, tmp_path):
    """rate, rate2, rate_batch and test of the two raters agree."""
    texts = _texts(5, (150, 40, 1, 0, 97))
    for text, ctx in zip(texts, ([3], None, [7], None, [19])):
        _close_ratings(tr.rate(text, ctx), jr.rate(text, ctx))
        (g, g_ppl), (w, w_ppl) = tr.rate2(text, ctx), jr.rate2(text, ctx)
        assert [c for c, _ in g] == [c for c, _ in w] == list(text)
        _close_ratings([p for _, p in g], [p for _, p in w])
        assert g_ppl == pytest.approx(w_ppl, rel=RTOL)
    for got, want in zip(tr.rate_batch(texts, [[3], None, [7], [1], [2]]),
                         jr.rate_batch(texts, [[3], None, [7], [1], [2]])):
        _close_ratings(got, want)
    files = []
    for i, text in enumerate(_texts(6, (120, 70, 3))):
        path = tmp_path / ('author%d_title_%d.txt' % (i, 100 + 40 * i))
        path.write_text(text, encoding='utf-8')
        files.append(str(path))
    assert tr.test(files) == pytest.approx(jr.test(files), rel=RTOL)


@pytest.mark.parametrize('mode', ['layered', 'layered_pallas', 'fused'])
def test_rater_api_matches_jax(mode, monkeypatch, tmp_path):
    """64-step chunks (a 150-char text takes 3 of them, bucketed to 4)
    with the carry threaded between them."""
    _small(monkeypatch, SCORE_CHUNK=64)
    jr, tr = _raters()
    jr.use_pallas = mode != 'layered'
    jr.fused_score = tr.fused_score = mode == 'fused'
    _check_api(jr, tr, tmp_path)


def test_fused_equals_layered_in_the_port(monkeypatch):
    _small(monkeypatch, SCORE_CHUNK=64)
    _, tr = _raters()
    texts = _texts(8, (150, 33))
    layered = tr.rate_batch(texts)
    tr.fused_score = True
    for got, want in zip(tr.rate_batch(texts), layered):
        _close_ratings(got, want)


def test_fused_packs_weights_once_per_params(monkeypatch):
    """The fused path packs the kernel's weights at its first call and
    reuses them until the params are replaced."""
    calls = []
    pack = trm.pack_score_weights

    def counting(params, cfg):
        calls.append(params)
        return pack(params, cfg)
    monkeypatch.setattr(trm, 'pack_score_weights', counting)
    _, tr = _raters()
    tr.fused_score = True
    text = _texts(11, (40,))[0]
    first = tr.rate(text, [3])
    assert tr.rate(text, [3]) == first and len(tr.rate_batch([text] * 3)) == 3
    assert len(calls) == 1
    _, other = _raters(seed=5)
    tr.params = other.params
    assert tr.rate(text, [3]) != first
    assert len(calls) == 2 and calls[1] is other.params


def test_superblock_chaining_matches_jax(monkeypatch):
    """With 16-step chunks and at most 2 of them per call, a 150-char
    text chains 5 super-blocks through the carry; it rates as the JAX
    package rates it, and as the port rates it in one block."""
    _, tr0 = _raters()
    text = _texts(9, (150,))[0]
    whole = tr0.rate2(text, [4])
    _small(monkeypatch, SCORE_CHUNK=16, CHUNK_COUNT_BUCKETS=(1, 2))
    jr, tr = _raters()
    for fused in (False, True):
        tr.fused_score = fused
        got, want = tr.rate2(text, [4]), jr.rate2(text, [4])
        for other in (want, whole):
            _close_ratings([p for _, p in got[0]], [p for _, p in other[0]])
            assert got[1] == pytest.approx(other[1], rel=RTOL)


def test_split_batch_carry_matches_jax(monkeypatch):
    """A batch over SCORE_SPLIT_LIMIT splits in half: each half gets its
    rows of the caller's carry, and the final carry comes back
    reassembled, as in the JAX package.  Probs and NLL sums also equal
    the unsplit batch's; its carry does not, as the carry runs on
    through the padding steps and the halves pad to fewer chunks."""
    _small(monkeypatch, SCORE_CHUNK=64)
    jr, tr = _raters()
    texts = _texts(10, (70, 20, 64, 5))
    out = {}
    for name, r in (('jax', jr), ('port', tr)):
        ids = [r.vocab.encode(t) for t in texts]
        _, _, carry0 = r._score_batch(ids, [None] * 4)
        out[name, 'whole'] = r._score_batch(ids, [None] * 4, carry=carry0)
        monkeypatch.setattr(jrm if name == 'jax' else trm,
                            'SCORE_SPLIT_LIMIT', 256)
        out[name, 'split'] = r._score_batch(ids, [None] * 4, carry=carry0)
    got = out['port', 'split']
    for want in (out['jax', 'split'], out['port', 'whole']):
        for a, b in zip(got[0], want[0]):
            _close_ratings(a, b)
        np.testing.assert_allclose(got[1], want[1], rtol=RTOL)
    for a, b in zip(got[2], out['jax', 'split'][2]):
        assert a.shape == b.shape == (2, 4, 32)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_stateless_fixed_window_matches_jax(tmp_path):
    """A stateless fixed-length model scores each char from its
    zero-padded 8-char window (``_rolling_window_probs``)."""
    jr, tr = _raters(stateful=False, length=8, seed=4)
    assert not tr.stateful and not tr.variable_length
    tr.batch_size = jr.batch_size = 16   # several window batches
    _check_api(jr, tr, tmp_path)


# ---------------------------------------------------------------------
# the processor and the command line
# ---------------------------------------------------------------------

def _char_ppls(caplog, name):
    return [float(m.group(1)) for rec in caplog.records
            if rec.name.startswith(name)
            for m in [re.search(r'char ppl: ([0-9.]+)', rec.getMessage())]
            if m]


def _word_confs(directory):
    ws = Workspace(directory)
    out = {}
    for f in ws.mets.find_files(fileGrp='OCR-D-LM'):
        pcgts = parse_page(os.path.join(directory, f.local_filename))
        for region in pcgts.get_Page().get_TextRegion():
            for line in region.get_TextLine():
                for word in line.get_Word():
                    out[word.id] = [(te.Unicode, te.conf)
                                    for te in word.get_TextEquiv()]
    return out


def test_processor_scoring_matches_jax(tmp_path, caplog):
    """Word-level scoring of the clean generated German pages of
    ``test_quality.py`` with ``model_german.h5`` (all three pages in one
    ``rate_batch``): the same confs as the JAX processor, one TextEquiv
    per word, and the char-ppl lines under the reference's bound of
    6.0, equal to the JAX processor's."""
    pages = _corpus_pages()
    outs = {}
    for name, cls, kw in (('jax', JKerasRate, {}),
                          ('port', TKerasRate, {'device': 'cpu'})):
        d = str(tmp_path / name)
        ws = build_workspace(d, pages)
        proc = cls(workspace=ws, parameter={
            'model_file': GERMAN, 'textequiv_level': 'word',
            'alternative_decoding': False}, **kw)
        proc.setup()
        assert proc.rater.batch_size == 1   # stateful model, as in JAX
        with caplog.at_level(logging.INFO):
            proc.process_workspace(ws)
        outs[name] = _word_confs(d)
    want, got = outs['jax'], outs['port']
    assert got.keys() == want.keys() and len(got) > 150
    for wid, w_tes in want.items():
        assert len(got[wid]) == len(w_tes) == 1, wid
        assert got[wid][0][0] == w_tes[0][0]
        assert abs(got[wid][0][1] - w_tes[0][1]) <= PROB_ATOL, wid
    t_ppl = _char_ppls(caplog, 'ocrd_keraslm_torch')
    j_ppl = _char_ppls(caplog, 'ocrd_keraslm_tpu')
    assert len(t_ppl) == len(pages) and float(np.mean(t_ppl)) < 6.0
    np.testing.assert_allclose(t_ppl, j_ppl, rtol=1e-3)


def test_score_page_pcgts_matches_jax(tmp_path):
    """The module-level one-page scorer (``rate`` of the whole page
    text, confidences blended by lm_weight) on a glyph page with
    alternatives: the first alternative is rated and kept."""
    jr, tr = _raters()
    build_workspace(str(tmp_path), {'p1': [['abc', 'de'], ['fghij', 'k']]},
                    glyph_alternatives={(0, 0, 1): [('b', 0.8), ('a', 0.7)],
                                        (1, 0, 2): [('h', 0.6),
                                                    ('k', 0.55)]})
    page = str(tmp_path / 'OCR-D-OCR' / 'OCR-D-OCR_p1.xml')
    confs = {}
    for name, r, mod, parse in (('jax', jr, jrate, parse_page),
                                ('port', tr, trate, tparse_page)):
        pcgts = parse(page)
        mod.score_page_pcgts(r, pcgts, 'glyph', [3], 0.5)
        confs[name] = [(g.id, [(te.Unicode, te.conf)
                               for te in g.get_TextEquiv()])
                       for region in pcgts.get_Page().get_TextRegion()
                       for line in region.get_TextLine()
                       for word in line.get_Word()
                       for g in word.get_Glyph()]
    assert [g for g, _ in confs['port']] == [g for g, _ in confs['jax']]
    for (_, got), (_, want) in zip(confs['port'], confs['jax']):
        assert len(got) == len(want) == 1
        assert got[0][0] == want[0][0]
        assert abs(got[0][1] - want[0][1]) <= PROB_ATOL


def test_keraslm_rate_apply_and_test_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv('KERASLM_PLATFORM', 'cpu')
    runner = CliRunner()
    text = 'Was ist Aufklärung? Sie ist der Ausgang des Menschen.'
    outs = {}
    for name, cli in (('jax', jcli), ('port', tcli)):
        res = runner.invoke(cli, ['-l', 'WARNING', 'apply', '-m', GERMAN,
                                  '-c', '1784', text])
        assert res.exit_code == 0, res.output
        ppl, ratings = res.output.strip().splitlines()[-2:]
        outs[name] = float(ppl), json.loads(ratings)
    assert outs['port'][0] == pytest.approx(outs['jax'][0], rel=RTOL)
    assert [c for c, _ in outs['port'][1]] == list(text)
    _close_ratings([p for _, p in outs['port'][1]],
                   [p for _, p in outs['jax'][1]])
    for i, body in enumerate(('Die Vernunft ist das Vermögen der '
                              'Prinzipien.', 'der Mensch denkt')):
        (tmp_path / ('kant_werk%d_178%d.txt' % (i, i))).write_text(
            body, encoding='utf-8')
    ppls = []
    for cli in (jcli, tcli):
        res = runner.invoke(cli, ['-l', 'WARNING', 'test', '-m', GERMAN,
                                  str(tmp_path)])
        assert res.exit_code == 0, res.output
        ppls.append(float(res.output.strip().splitlines()[-1]))
    assert ppls[1] == pytest.approx(ppls[0], rel=RTOL)


@pytest.mark.parametrize('args, item', [
    # train --mesh, generate, then prune-charset, print-charset and
    # --jax-trace were ported since; each case keeps the id it had
    pytest.param(['train', '--mesh', '1'], 'Distributed',
                 id='args0-Distributed'),
    pytest.param(['prune-charset', '-m', 'MODEL', 'J'], 'CLI and tooling',
                 id='args1-Generation'),
    (['print-charset', '-m', GERMAN], 'CLI and tooling'),
    (['--jax-trace', 'TRACE', 'test', '-m', GERMAN, 'DATA'],
     'Device trace')])
def test_keraslm_rate_unported_commands_raise(args, item, tmp_path,
                                              monkeypatch):
    """``train --mesh`` (over a mesh of one rank here; two and four
    ranks in ``tests/test_torch_{parallel,pipeline,multihost}.py``)
    trains as without a mesh; the other three commands are ported and
    run as
    JAX's do (``tests/test_torch_cli_tooling.py`` holds them against
    JAX in full)."""
    monkeypatch.setenv('KERASLM_PLATFORM', 'cpu')
    assert tcli.list_commands(None)[:3] == ['train', 'test', 'apply']
    if item == 'Distributed':
        # a mesh of one rank (the command joins a world of one): the
        # sharded step trains as the unsharded one, from the same seeds
        import random
        from ocrd_keraslm_torch.parallel import multihost
        from ocrd_keraslm_torch.utils import h5io
        monkeypatch.setenv('KERASLM_CKPT_DIR', str(tmp_path / 'ck'))
        (tmp_path / 'data').mkdir()
        for i, body in enumerate(('die vernunft ist kant ' * 20,
                                  'der mensch denkt und ist ' * 20)):
            (tmp_path / 'data' / ('kant_werk%d_178%d.txt' % (i, i))
             ).write_text(body, encoding='utf-8')
        hists = []
        for extra in ([], args[1:]):
            random.seed(3)
            np.random.seed(4)
            model = str(tmp_path / ('m%d.h5' % len(extra)))
            try:
                res = CliRunner().invoke(tcli, [
                    '-l', 'WARNING', 'train', '-m', model, '-w', '16', '-d',
                    '1', '-l', '16', '-b', '4', '-e', '1'] + extra + [
                    str(tmp_path / 'data')])
            finally:
                multihost.shutdown()
            assert res.exit_code == 0, (res.output, res.exception)
            hists.append(h5io.load_config(model)[2])
        for key in hists[0]:
            np.testing.assert_allclose(hists[1][key], hists[0][key],
                                       rtol=1e-5, err_msg=key)
        return
    model = str(tmp_path / 'm.h5')
    data = tmp_path / 'kant_werk_1784.txt'
    data.write_text('Die Vernunft ist das Vermögen der Prinzipien.',
                    encoding='utf-8')
    import shutil
    shutil.copy(GERMAN, model)
    subst = {'MODEL': model, 'TRACE': str(tmp_path / 'trace'),
             'DATA': str(data)}
    args = [subst.get(a, a) for a in args]
    res = CliRunner().invoke(tcli, ['-l', 'WARNING'] + args)
    assert res.exit_code == 0, (res.output, res.exception)
    # JAX's run of the same command, without the trace
    want = CliRunner().invoke(jcli, ['-l', 'WARNING'] + (
        args[2:] if args[0] == '--jax-trace' else args))
    if item == 'Device trace':
        trace, = os.listdir(tmp_path / 'trace')
        with open(tmp_path / 'trace' / trace) as fh:
            assert json.load(fh)['traceEvents']
        assert float(res.output.strip().splitlines()[-1]) == \
            pytest.approx(float(want.output.strip().splitlines()[-1]),
                          rel=RTOL)
    elif args[0] == 'print-charset':
        assert res.output == want.output
    else:
        from ocrd_keraslm_torch.utils import h5io
        assert 'J' not in h5io.load_config(model)[1].c2i
        assert 'J' in h5io.load_config(GERMAN)[1].c2i


def test_context_beyond_the_table_reads_its_last_row():
    """A context id past the model's 20-row table (a year after its
    range, 1784 -> 179) reads the table's last row in both packages,
    when scoring and when decoding."""
    from ocrd_keraslm_tpu.wrapper.page import TextEquivType
    jr, tr = _raters()
    text = _texts(12, (60,))[0]
    for ctx in ([179], [19]):
        (g, g_ppl), (w, w_ppl) = tr.rate2(text, ctx), jr.rate2(text, ctx)
        _close_ratings([p for _, p in g], [p for _, p in w])
        assert g_ppl == pytest.approx(w_ppl, rel=RTOL)
    assert tr.rate2(text, [179])[1] == tr.rate2(text, [19])[1]
    edges = [{'element': None, 'alternatives': [
        TextEquivType(Unicode=c, conf=0.9)]} for c in 'abcab']
    p_t, e_t, _ = tr.rate_best_device(edges, 0, 5, context=[179])
    p_j, e_j, _ = jr.rate_best_device(edges, 0, 5, context=[179])
    assert e_t == pytest.approx(e_j, rel=RTOL)

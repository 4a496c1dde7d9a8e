"""The slice as a whole: the port's ``ocrd-keraslm-rate`` processor
against the JAX processor on the same workspaces.

Both decode at glyph level with beam decoding on the device (JAX: the
fused Pallas kernel in interpret mode, its native page lane off; port:
the CPU).  Per glyph the chosen ``Unicode`` must be the same and the
written ``conf`` within 1e-5 (confs are written as '%.6g'); the
re-projected word, line and region texts must be identical."""
import os
import subprocess
import sys

import pytest
import torch

from helpers import build_workspace, make_tiny_model
from ocrd_keraslm_tpu.wrapper import KerasRate as JKerasRate
from ocrd_keraslm_tpu.wrapper.mets import Workspace
from ocrd_keraslm_tpu.wrapper.page import parse_page
from ocrd_keraslm_torch.wrapper import KerasRate as TKerasRate

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
GERMAN = os.path.join(REPO, 'pretrained', 'model_german.h5')

PAGES = {
    'phys_0001': [['Was', 'ist', 'Aufklärung'],
                  ['der', 'Mensch', 'denkt']],
    'phys_0002': [['die', 'Vernunft', 'siegt'],
                  ['am', 'Ende', 'doch']],
}
ALTERNATIVES = {(li, wi, 0): [('X', 0.93), ('Y', 0.91)]
                for li in range(2) for wi in range(3)}


def _outputs(directory):
    """(output file IDs, {glyph id: [(Unicode, conf)]}, {id: text} of
    words, lines and regions)."""
    ws = Workspace(directory)
    files = sorted(f.ID for f in ws.mets.find_files(fileGrp='OCR-D-LM'))
    glyphs, texts = {}, {}
    for f in ws.mets.find_files(fileGrp='OCR-D-LM'):
        pcgts = parse_page(os.path.join(directory, f.local_filename))
        for region in pcgts.get_Page().get_TextRegion():
            texts[region.id] = [te.Unicode for te in region.get_TextEquiv()]
            for line in region.get_TextLine():
                texts[line.id] = [te.Unicode for te in line.get_TextEquiv()]
                for word in line.get_Word():
                    texts[word.id] = [te.Unicode
                                      for te in word.get_TextEquiv()]
                    for g in word.get_Glyph():
                        glyphs[g.id] = [(te.Unicode, te.conf)
                                        for te in g.get_TextEquiv()]
    return files, glyphs, texts


def _run_both(tmp_path, monkeypatch, pages, alternatives, model, params):
    monkeypatch.setenv('KERASLM_NATIVE_PAGE', '0')
    dirs = {}
    for name in ('jax', 'torch'):
        d = str(tmp_path / name)
        ws = build_workspace(d, pages, glyph_alternatives=alternatives)
        parameter = dict(params, model_file=model)
        if name == 'jax':
            proc = JKerasRate(workspace=ws, parameter=parameter)
            proc.setup()
            proc.rater.fused_decode = True
        else:
            proc = TKerasRate(workspace=ws, parameter=parameter,
                              device='cpu')
            proc.setup()
        proc.process_workspace(ws)
        dirs[name] = d
    return _outputs(dirs['jax']), _outputs(dirs['torch'])


def _assert_same(want, got, conf_tol):
    w_files, w_glyphs, w_texts = want
    g_files, g_glyphs, g_texts = got
    assert g_files == w_files and w_files
    assert g_glyphs.keys() == w_glyphs.keys() and w_glyphs
    for gid, w_tes in w_glyphs.items():
        g_tes = g_glyphs[gid]
        assert len(g_tes) == len(w_tes) == 1, gid
        assert g_tes[0][0] == w_tes[0][0], gid
        assert abs(g_tes[0][1] - w_tes[0][1]) <= conf_tol, \
            (gid, g_tes, w_tes)
    assert g_texts == w_texts


def test_two_page_glyph_alternatives_match_jax(tmp_path, monkeypatch):
    model = make_tiny_model(tmp_path / 'model.h5',
                            chars='abcdefghijklmnorstuvwzäßAVEMWXY '
                                  'üD\nkfgp')
    want, got = _run_both(tmp_path, monkeypatch, PAGES, ALTERNATIVES, model,
                          {'textequiv_level': 'glyph', 'beam_width': 3})
    _assert_same(want, got, 1e-5)


def test_full_width_german_page_matches_jax(tmp_path, monkeypatch):
    """One page at full width (model_german.h5, W=128, V=70 padded to
    128, default beam 10 -> K=16, merged runs -> L=8)."""
    pages = {'phys_0001': [['Was', 'ist', 'Aufklärung'],
                           ['Sie', 'ist', 'der', 'Ausgang', 'des',
                            'Menschen'],
                           ['aus', 'seiner', 'Unmündigkeit']]}
    alternatives = {(0, 2, 3): [('k', 0.9), ('l', 0.88)],
                    (1, 4, 1): [('o', 0.9), ('e', 0.86), ('a', 0.85)],
                    (2, 1, 0): [('f', 0.92), ('s', 0.9)],
                    (2, 2, 2): [('n', 0.9), ('u', 0.89), ('m', 0.84),
                                ('w', 0.83)]}
    want, got = _run_both(tmp_path, monkeypatch, pages, alternatives,
                          GERMAN, {'textequiv_level': 'glyph'})
    _assert_same(want, got, 1e-5)


def test_cli_module_runs_on_cpu(tmp_path):
    build_workspace(str(tmp_path), PAGES, glyph_alternatives=ALTERNATIVES)
    env = dict(os.environ, KERASLM_PLATFORM='cpu')
    proc = subprocess.run(
        [sys.executable, '-m', 'ocrd_keraslm_torch.wrapper.cli',
         '-m', str(tmp_path / 'mets.xml'), '-I', 'OCR-D-OCR',
         '-O', 'OCR-D-LM', '-P', 'model_file', GERMAN,
         '-P', 'beam_width', '4'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    files, glyphs, texts = _outputs(str(tmp_path))
    assert len(files) == len(PAGES)
    assert glyphs and all(len(tes) == 1 for tes in glyphs.values())
    for word_id, (text,) in texts.items():
        if '_w' in word_id:
            assert text == ''.join(glyphs[g][0][0] for g in sorted(
                (g for g in glyphs if g.startswith(word_id + '_g')),
                key=lambda g: int(g.rsplit('_g', 1)[1])))


def test_cli_module_scores_on_cpu(tmp_path):
    """``-P alternative_decoding false`` reaches the processor: scoring
    mode keeps the first alternative of every glyph and writes every
    page."""
    build_workspace(str(tmp_path), PAGES, glyph_alternatives=ALTERNATIVES)
    env = dict(os.environ, KERASLM_PLATFORM='cpu')
    proc = subprocess.run(
        [sys.executable, '-m', 'ocrd_keraslm_torch.wrapper.cli',
         '-m', str(tmp_path / 'mets.xml'), '-I', 'OCR-D-OCR',
         '-O', 'OCR-D-LM', '-P', 'model_file', GERMAN,
         '-P', 'alternative_decoding', 'false'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert 'char ppl' in proc.stderr
    files, glyphs, _ = _outputs(str(tmp_path))
    assert len(files) == len(PAGES)
    assert glyphs and all(len(tes) == 1 for tes in glyphs.values())
    assert {tes[0][0] for gid, tes in glyphs.items()
            if gid.endswith('_g0')} >= {'X'}   # first alternatives kept


@pytest.mark.parametrize('param, value', [
    ('alternative_decoding', False), ('device_decoding', False),
    ('lookahead_writeback', True)])
def test_unported_parameters_raise(param, value):
    """Parameters that select paths not ported yet raise, naming their
    ROADMAP.md item.  Scoring (``alternative_decoding=false``) is
    ported: the processor is built in scoring mode, a stateful model
    with batch size 1, as in the JAX processor."""
    kwargs = dict(parameter={'model_file': GERMAN, param: value},
                  device='cpu')
    if param == 'alternative_decoding':
        proc = TKerasRate(**kwargs)
        proc.setup()
        assert proc.rater.stateful and proc.rater.batch_size == 1
        return
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        TKerasRate(**kwargs)


@pytest.mark.parametrize('var', ['KERASLM_NATIVE_PAGE',
                                 'KERASLM_FUSE_PAGES'])
def test_unported_lanes_raise(var, monkeypatch):
    """The JAX processor's native page lane and page-group fusion:
    asked for, they raise; switched off (0), the processor is built."""
    monkeypatch.setenv(var, '1')
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        TKerasRate(parameter={'model_file': GERMAN}, device='cpu')
    monkeypatch.setenv(var, '0')
    TKerasRate(parameter={'model_file': GERMAN}, device='cpu')

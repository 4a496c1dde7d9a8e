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

import numpy as np
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
    """The JAX processor's parameters build the port's processor, each
    in its mode: scoring (``alternative_decoding=false``: a stateful
    model with batch size 1, as in the JAX processor), the host decode
    engine (``device_decoding=false``: incremental decoding) and
    lookahead write-back (``lookahead_writeback=true``: the record lane,
    never the native lane)."""
    kwargs = dict(parameter={'model_file': GERMAN, param: value},
                  device='cpu')
    proc = TKerasRate(**kwargs)
    proc.setup()
    if param == 'alternative_decoding':
        assert proc.rater.stateful and proc.rater.batch_size == 1
        return
    assert not proc.rater.stateful and proc.rater.incremental
    if param == 'device_decoding':
        assert proc.parameter['device_decoding'] is False
        return
    assert proc.parameter['lookahead_writeback'] is True
    assert not proc._native_page_eligible()


@pytest.mark.parametrize('var', ['KERASLM_NATIVE_PAGE',
                                 'KERASLM_FUSE_PAGES'])
def test_unported_lanes_raise(var, tmp_path, monkeypatch):
    """The JAX processor's native page lane and page-group fusion, on by
    default as there: asked for (unset or 1), the processor takes the
    lane and its counter moves; switched off (0), it does not."""
    from ocrd_keraslm_torch.wrapper import page_native
    counter = 'pages' if var == 'KERASLM_NATIVE_PAGE' else 'groups'
    seen = {}
    for value in (None, '1', '0'):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
        d = str(tmp_path / ('ws_%s' % value))
        ws = build_workspace(d, PAGES, glyph_alternatives=ALTERNATIVES)
        proc = TKerasRate(workspace=ws, parameter={
            'model_file': GERMAN, 'beam_width': 3}, device='cpu')
        proc.setup()
        setattr(page_native, counter, 0)
        proc.process_workspace(ws)
        seen[value] = getattr(page_native, counter)
        assert len(_outputs(d)[0]) == len(PAGES)
    want = len(PAGES) if counter == 'pages' else 1
    assert seen == {None: want, '1': want, '0': 0}, seen


# page 1: a 79-char line in a 113-char region (beyond the decode kernel's
# 64 chars at line and region level); page 2: short lines
LONG_PAGES = {
    'phys_0001': [['Was', 'ist', 'Aufklärung'],
                  ['Aufklärung', 'ist', 'Ausgang', 'des', 'Menschen', 'aus',
                   'seiner', 'selbstverschuldeten', 'Unmündigkeit'],
                  ['Habe', 'Mut,', 'dich']],
    'phys_0002': [['die', 'Vernunft', 'siegt'], ['am', 'Ende', 'doch']],
}


def test_beam_32_german_pages_match_jax(tmp_path, monkeypatch):
    """``-P beam_width 32`` (K=32: JAX's Pallas kernel at its 128-lane
    design point, K*A = 128 candidates) over 2 glyph pages at full width
    (model_german.h5): the same choices and texts, confs within 1e-5."""
    alternatives = {**ALTERNATIVES,
                    (1, 1, 0): [('M', 0.9), ('W', 0.88), ('N', 0.87),
                                ('H', 0.85)],
                    (0, 2, 4): [('ä', 0.9), ('a', 0.89), ('o', 0.84)]}
    want, got = _run_both(tmp_path, monkeypatch, PAGES, alternatives,
                          GERMAN, {'textequiv_level': 'glyph',
                                   'beam_width': 32})
    _assert_same(want, got, 1e-5)


def _level_confs(directory, level):
    """{id: [(Unicode, conf)]} of the output's lines or regions."""
    ws = Workspace(directory)
    out = {}
    for f in ws.mets.find_files(fileGrp='OCR-D-LM'):
        pcgts = parse_page(os.path.join(directory, f.local_filename))
        for region in pcgts.get_Page().get_TextRegion():
            elements = [region] if level == 'region' else \
                region.get_TextLine()
            for el in elements:
                out[el.id] = [(te.Unicode, te.conf)
                              for te in el.get_TextEquiv()]
    return out


def _run_default(tmp_path, pages, alternatives, params):
    """Both processors at their defaults (the JAX one: its XLA engine on
    the CPU; the port: its page lanes, the kernel's plain version where
    the kernel takes the page and the engine elsewhere); returns the two
    output directories."""
    dirs = []
    for name, cls, kw in (('jax', JKerasRate, {}),
                          ('torch', TKerasRate, {'device': 'cpu'})):
        d = str(tmp_path / name)
        ws = build_workspace(d, pages, glyph_alternatives=alternatives)
        proc = cls(workspace=ws, parameter=dict(params, model_file=GERMAN),
                   **kw)
        proc.setup()
        proc.process_workspace(ws)
        dirs.append(d)
    return dirs


def test_wide_beam_pages_match_jax(tmp_path):
    """``-P beam_width 40`` (K=64, the unbounded engine) over 3 glyph
    pages: every page written, the JAX processor's choices, confs within
    1e-4."""
    pages = dict(PAGES, phys_0003=[['Sapere', 'aude']])
    alternatives = {**ALTERNATIVES, (0, 1, 2): [('p', 0.9), ('b', 0.89)]}
    want, got = (_outputs(d) for d in _run_default(
        tmp_path, pages, alternatives, {'beam_width': 40}))
    assert len(got[0]) == 3
    _assert_same(want, got, 1e-4)


@pytest.mark.parametrize('level, n_chars', [('line', 79),
                                            ('region', 113)])
def test_long_texts_match_jax(tmp_path, level, n_chars):
    """``textequiv_level`` line (a 79-char line) and region (a 113-char
    region): the page with the long text decodes through the engine, the
    short page through the kernel, the carry handed between them; every
    page written, the JAX processor's texts, confs within 1e-4."""
    lengths = [len(' '.join(words)) for words in LONG_PAGES['phys_0001']]
    assert (max(lengths) if level == 'line' else
            sum(lengths) + len(lengths) - 1) == n_chars
    want, got = (_level_confs(d, level) for d in _run_default(
        tmp_path, LONG_PAGES, None, {'textequiv_level': level}))
    assert got.keys() == want.keys() and len(want) == \
        (5 if level == 'line' else 2)
    for key, w_tes in want.items():
        g_tes = got[key]
        assert [u for u, _ in g_tes] == [u for u, _ in w_tes], key
        np.testing.assert_allclose([c for _, c in g_tes],
                                   [c for _, c in w_tes], rtol=0, atol=1e-4)
    assert any(len(u) == n_chars for tes in got.values() for u, _ in tes)


@pytest.mark.parametrize('policy', [None, 'SKIP', 'COPY'])
def test_unported_feature_raises_through_the_processor(tmp_path,
                                                       monkeypatch, policy):
    """What the port does not have yet raises its NotImplementedError out
    of the processor under every OCRD_MISSING_OUTPUT policy, instead of
    skipping the page and exiting 0 (here a decode launch that raises
    one, as an unported feature's does, naming its ROADMAP item)."""
    if policy is None:
        monkeypatch.delenv('OCRD_MISSING_OUTPUT', raising=False)
    else:
        monkeypatch.setenv('OCRD_MISSING_OUTPUT', policy)
    ws = build_workspace(str(tmp_path), PAGES,
                         glyph_alternatives=ALTERNATIVES)
    proc = TKerasRate(workspace=ws, parameter={'model_file': GERMAN},
                      device='cpu')
    proc.setup()

    def unported(*args, **kwargs):
        raise NotImplementedError('a decode sharded over a mesh is not '
                                  'ported yet (ROADMAP.md Queue 1, '
                                  '"Distributed")')
    monkeypatch.setattr(proc.rater, '_launch_decode', unported)
    with pytest.raises(NotImplementedError, match='Distributed'):
        proc.process_workspace(ws)


# confs under the bf16 decode mode at full width: JAX's tanh and sigmoid
# (XLA's approximations) leave its f32 h a few ulps off the port's, and
# at K=16, W=128, D=2 some of the 4096 h values of a char step round to
# the other bf16 neighbour, each moving the costs after it by ~1e-3
# bits: over a page of long lines the line confs part by more than 1e-4
BF16_CONF_TOL = 2e-3


def _run_bf16(tmp_path, pages, alternatives, params):
    """Both processors with ``rater.decode_bf16 = True`` (the JAX one
    with its Pallas kernels in interpret mode, ``fused_decode``; the
    port at its defaults: the native page lane and page groups where the
    kernel takes the pages); returns the two output directories and the
    pages the port's native lane served."""
    from ocrd_keraslm_torch.wrapper import page_native
    dirs = []
    for name, cls, kw in (('jax', JKerasRate, {}),
                          ('torch', TKerasRate, {'device': 'cpu'})):
        d = str(tmp_path / name)
        ws = build_workspace(d, pages, glyph_alternatives=alternatives)
        proc = cls(workspace=ws, parameter=dict(params, model_file=GERMAN),
                   **kw)
        proc.setup()
        if name == 'jax':
            proc.rater.fused_decode = True
        proc.rater.decode_bf16 = True
        page_native.pages = 0
        proc.process_workspace(ws)
        dirs.append(d)
    return dirs, page_native.pages


@pytest.mark.parametrize('lookahead', [False, True])
def test_bf16_decode_matches_jax(tmp_path, monkeypatch, lookahead):
    """The bf16 decode mode through the processor at glyph level: the
    port's native lane serves every page (one page group), or with
    ``lookahead_writeback`` the record lane walks the pages in reverse;
    JAX's texts, confs within ``BF16_CONF_TOL`` (bf16 weights of
    model_german.h5 at full width)."""
    monkeypatch.delenv('KERASLM_NATIVE_PAGE', raising=False)
    alternatives = {**ALTERNATIVES, (0, 1, 2): [('p', 0.9), ('b', 0.89)]}
    (jax_dir, torch_dir), served = _run_bf16(
        tmp_path, PAGES, alternatives, {'textequiv_level': 'glyph',
                                        'lookahead_writeback': lookahead})
    assert served == (0 if lookahead else len(PAGES))
    want, got = _outputs(jax_dir), _outputs(torch_dir)
    _assert_same(want, got, BF16_CONF_TOL)


def test_bf16_decode_hands_the_carry_to_the_engine(tmp_path):
    """Under the bf16 decode mode at line level, a page with a 79-char
    line between two short pages: kernel (bf16), engine (f32, x
    recovered from the bf16 carry), kernel again, in both packages;
    JAX's texts, confs within ``BF16_CONF_TOL``."""
    pages = {'phys_0001': PAGES['phys_0001'],
             'phys_0002': LONG_PAGES['phys_0001'],
             'phys_0003': PAGES['phys_0002']}
    (jax_dir, torch_dir), _ = _run_bf16(tmp_path, pages, None,
                                        {'textequiv_level': 'line'})
    want, got = (_level_confs(d, 'line') for d in (jax_dir, torch_dir))
    assert got.keys() == want.keys() and len(want) == 7
    for key, w_tes in want.items():
        g_tes = got[key]
        assert [u for u, _ in g_tes] == [u for u, _ in w_tes], key
        np.testing.assert_allclose([c for _, c in g_tes],
                                   [c for _, c in w_tes], rtol=0,
                                   atol=BF16_CONF_TOL)
    assert any(len(u) == 79 for tes in got.values() for u, _ in tes)

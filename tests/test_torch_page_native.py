"""The port's native page lane (``wrapper/page_native.py`` over its own
``native_src/page_scan.cpp``) against the JAX package's native lane
and the port's own ElementTree and object-model lanes: the scan's
structure, entities and multibyte text, bails, the lattice arrays (bit
for bit, word and glyph level, run merging on and off), the C++ apply
against the Python apply, the splice write-back, joins, and the
processor end to end over the three lanes.

Decoded documents are compared by parsed content (every element's
texts and confs rounded to 5 places, ``test_page_fast._page_content``)
and, where both sides splice, byte for byte up to the run's
timestamps."""
import os
import re
import string

import numpy as np
import pytest
import torch

from ocrd_keraslm_tpu.wrapper.page import to_xml as j_to_xml
from ocrd_keraslm_tpu.wrapper.page_native import NativePageDoc as JDoc
from ocrd_keraslm_torch.rater import DECODE_MERGE_MAX, Rater as TRater
from ocrd_keraslm_torch.wrapper import page_native
from ocrd_keraslm_torch.wrapper.page import parse_page
from ocrd_keraslm_torch.wrapper.page_fast import parse_page_fast
from ocrd_keraslm_torch.wrapper.page_native import NativePageDoc
from ocrd_keraslm_torch.wrapper.rate import (
    page_get_linear_lattice_at, page_update_higher_textequiv_levels)

from helpers import build_pcgts, build_workspace, make_tiny_model
from test_page_fast import _page_content, _rich_page_xml

# Small shapes: one intra-op thread, so that test workers running side
# by side do not oversubscribe the cores.
torch.set_num_threads(1)

ARRAYS = ('ekind', 'eparent', 'erd', 'etlo', 'econtent_end', 'espan',
          'eself', 'eid', 'efirst_te', 'towner', 'tconf', 'tindex',
          'tspan', 'tconf_span', 'ttag_insert', 'ttext')


def _strip_ts(xml):
    return re.sub(r'<(Created|LastChange)>[^<]*</\1>', r'<\1/>', xml)


def _table():
    r = TRater(device='cpu')
    r.vocab.assign(string.printable[:99])
    return r.vocab._table()


def _glyphs(pcgts):
    return [g for r in pcgts.get_Page().get_AllRegions()
            for li in r.get_TextLine() for w in li.get_Word()
            for g in w.get_Glyph()]


def test_scan_structure_equals_jax_and_object_model():
    xml = _rich_page_xml().encode('utf-8')
    doc, jdoc = NativePageDoc(xml), JDoc(xml)
    assert doc.bail is None and jdoc.bail is None
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(doc, name),
                                      getattr(jdoc, name), err_msg=name)
    assert doc.text_blob == jdoc.text_blob and doc.id_blob == jdoc.id_blob
    obj = parse_page(xml)
    regions = obj.get_Page().get_AllRegions()
    lines = [li for r in regions for li in r.get_TextLine()]
    words = [w for li in lines for w in li.get_Word()]
    glyphs = _glyphs(obj)
    assert list(np.bincount(doc.ekind, minlength=4)) == [
        len(regions), len(lines), len(words), len(glyphs)]
    for gi, g in zip(np.nonzero(doc.ekind == 3)[0], glyphs):
        assert doc.elem_id(int(gi)) == g.id
        assert doc.te_text(int(doc.efirst_te[gi])) == \
            g.get_TextEquiv()[0].Unicode
    assert doc.get_pcGtsId() == obj.get_pcGtsId() == 'p1'


def test_scan_entities_and_multibyte():
    xml = j_to_xml(build_pcgts([['Mü<h&e', '—ß']], page_id='p&1')) \
        .encode('utf-8')
    doc = NativePageDoc(xml)
    assert doc.bail is None
    assert doc.get_pcGtsId() == 'p&1'
    words = np.nonzero(doc.ekind == 2)[0]
    assert [doc.te_text(int(doc.efirst_te[w])) for w in words] == \
        ['Mü<h&e', '—ß']
    # CRLF normalises to LF in parsed text, as in the ElementTree lanes
    crlf = NativePageDoc(_rich_page_xml().encode('utf-8')
                         .replace(b'\n', b'\r\n'))
    assert crlf.bail is None
    for gi, g in zip(np.nonzero(crlf.ekind == 3)[0],
                     _glyphs(parse_page(_rich_page_xml()))):
        assert crlf.te_text(int(crlf.efirst_te[gi])) == \
            g.get_TextEquiv()[0].Unicode


def test_scan_bails_are_counted():
    xml = _rich_page_xml()
    cases = [
        '<?xml version="1.0" encoding="ISO-8859-1"?><PcGts/>',
        '<!DOCTYPE PcGts [<!ENTITY x "y">]><PcGts xmlns="http://schema.'
        'primaresearch.org/PAGE/gts/pagecontent/2019-07-15"/>',
        '<other/>',
        xml.replace('<TextRegion id="p1_r2">', '<TextRegion id="p1_r2">'
                    '<TextRegion id="nested"></TextRegion>'),
        xml.replace('Das', 'D&unknown;as'),
        xml.replace('<LastChange>', '<Ignored>')
        .replace('</LastChange>', '</Ignored>'),
        xml.replace('<PcGts xmlns="', '<pc:PcGts xmlns:pc="')
        .replace('</PcGts>', '</pc:PcGts>'),
    ]
    page_native.bails = 0
    for bad in cases:
        doc, jdoc = NativePageDoc(bad.encode()), JDoc(bad.encode())
        assert doc.bail is not None and doc.bail == jdoc.bail, bad[:60]
    assert page_native.bails == len(cases)
    # a flat page's ReadingOrder is inert and does not bail
    with_ro = xml.replace(
        '</Page>', '<ReadingOrder><OrderedGroup id="ro"><RegionRefIndexed '
        'index="0" regionRef="p1_r1"/></OrderedGroup></ReadingOrder>'
        '</Page>')
    assert NativePageDoc(with_ro.encode()).bail is None
    assert page_native.bails == len(cases)


@pytest.mark.parametrize('level', ['glyph', 'word'])
@pytest.mark.parametrize('merge', [True, False])
def test_lattice_arrays_bit_exact(level, merge):
    """The lattice and the kernel arrays equal the JAX package's native
    doc and the port's record lane through the C++ decode fill."""
    from ocrd_keraslm_torch import native
    xml = _rich_page_xml().encode('utf-8')
    doc, jdoc = NativePageDoc(xml), JDoc(xml)
    lat = doc.lattice(level, merge, DECODE_MERGE_MAX)
    assert lat is not None
    assert lat == jdoc.lattice(level, merge, DECODE_MERGE_MAX)
    n_raw, n_prep, maxlen = lat
    edges = page_get_linear_lattice_at(level, parse_page_fast(xml))
    assert n_raw == len(edges)
    assert (n_prep, maxlen) == tuple(native.decode_scan(
        edges, merge, DECODE_MERGE_MAX))
    E, A, L = max(n_prep, 8), 4, max(maxlen, 2)
    table = _table()
    got = doc.fill(table, E, A, L)
    want = native.decode_fill(edges, merge, DECODE_MERGE_MAX, E, A, L,
                              table)[1:]
    jgot = jdoc.fill(table, E, A, L)
    for name, g, w, j in zip(('chars', 'mask', 'conf', 'valid'), got, want,
                             jgot):
        np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(g, j, err_msg=name)


def _decode_and_serialize(doc, level, pick=0):
    """Apply a decode that picks alternative ``pick`` of every edge,
    each element scoring 0.75 a char, then serialize."""
    n_raw, n_prep, maxlen = doc.lattice(level, True, DECODE_MERGE_MAX)
    doc.fill(_table(), max(n_prep, 8), 4, max(maxlen, 2))
    choices = np.full(n_prep, pick, np.int64)
    n_alts = (doc.alt_te != -2).sum(1)
    lens = np.maximum(doc.alt_len[np.arange(n_prep),
                                  np.minimum(choices, n_alts - 1)], 1)
    run_tot = np.zeros(n_prep)
    if len(doc.piece_edge):
        np.add.at(run_tot, doc.piece_edge, doc.piece_len)
    per_edge = np.where(doc.edge_kind == 1, run_tot, lens)
    doc.apply_decode(level, choices, np.cumsum(-np.log2(0.75) * per_edge),
                     0.0)
    doc.set_pcGtsId('out')
    return doc.fast_tostring()


def _btt_rtl_page_xml():
    """A bottom-to-top region, a right-to-left line, an empty
    self-closing word and a tab-indented self-closing word."""
    xml = _rich_page_xml().replace(
        '<TextRegion id="p1_r1">',
        '<TextRegion id="p1_r1" textLineOrder="bottom-to-top">').replace(
        '<TextLine id="p1_r1_l0">',
        '<TextLine id="p1_r1_l0" readingDirection="right-to-left">')
    return xml.replace('</Word>', '</Word><Word id="p1_w_empty"/>'
                       '<Word\n\tid="p1_w_tabbed"/>', 1)


@pytest.mark.parametrize('level', ['glyph', 'word'])
@pytest.mark.parametrize('xml_fn', [_rich_page_xml, _btt_rtl_page_xml])
@pytest.mark.parametrize('pick', [0, 1])
def test_apply_native_equals_python_and_jax(level, xml_fn, pick,
                                            monkeypatch):
    """The C++ apply and splice (``page_apply``/``page_emit``) equal the
    Python apply and splice byte for byte, and the JAX package's native
    lane; the projected content equals the port's object-model
    projection of the same choices."""
    data = xml_fn().encode('utf-8')
    outs = {}
    for mode in ('1', '0'):
        monkeypatch.setenv('KERASLM_NATIVE_APPLY', mode)
        doc = NativePageDoc(data)
        assert doc.bail is None
        outs[mode] = _strip_ts(_decode_and_serialize(doc, level, pick))
        assert doc._native_applied == (mode == '1')
        outs['jax' + mode] = _strip_ts(_decode_and_serialize(
            JDoc(data), level, pick))
    assert outs['1'] == outs['0'] == outs['jax1'] == outs['jax0']
    # the object model, the same choices, the same 0.75 scores
    from ocrd_keraslm_torch.wrapper.page import to_xml
    from ocrd_keraslm_torch.wrapper.rate import _page_update_from_path
    obj = parse_page(data)
    path = [(e['element'], e['alternatives'][min(pick, len(
        e['alternatives']) - 1)], 0.75)
        for e in page_get_linear_lattice_at(level, obj)]
    _page_update_from_path(level, path, 1.0)
    page_update_higher_textequiv_levels(level, obj)
    obj.set_pcGtsId('out')
    assert _page_content(outs['1'])[1] == _page_content(to_xml(obj))[1]


def test_self_closing_tabbed_word_reopens_cleanly(monkeypatch):
    import xml.etree.ElementTree as ET
    data = _btt_rtl_page_xml().encode('utf-8')
    for mode in ('1', '0'):
        monkeypatch.setenv('KERASLM_NATIVE_APPLY', mode)
        out = _decode_and_serialize(NativePageDoc(data), 'glyph')
        assert '</p1_w_tabbed' not in out
        ns = {'p': re.search(r'xmlns="([^"]+)"', out).group(1)}
        w = ET.fromstring(out.encode()).find(
            './/p:Word[@id="p1_w_tabbed"]', ns)
        assert w is not None and len(w) == 1


def _joined(words=(['Auf', 'klae'], ['rung', 'jetzt']), form='join'):
    pcgts = build_pcgts([list(w) for w in words])
    lines = pcgts.page.get_TextRegion()[0].get_TextLine()
    src, tgt = lines[0].get_Word()[-1].id, lines[1].get_Word()[0].id
    refs = ('<SourceRegionRef regionRef="%s"/><TargetRegionRef '
            'regionRef="%s"/>' if form == 'join' else
            '<RegionRef regionRef="%s"/><RegionRef regionRef="%s"/>') \
        % (src, tgt)
    ro = '' if form == 'join' else (
        '<ReadingOrder><OrderedGroup id="ro"><RegionRefIndexed index="0" '
        'regionRef="page1_r1"/></OrderedGroup></ReadingOrder>')
    xml = j_to_xml(pcgts).replace(
        '</Page>', ro + '<Relations><Relation type="join">' + refs +
        '</Relation></Relations></Page>')
    return xml, (src, tgt)


@pytest.mark.parametrize('form', ['join', 'regionref'])
def test_joins(form, monkeypatch):
    """A Relation type=join between the last word of a line and the
    first of the next suppresses the newline in the region's text: the
    scanner collects the pair (not ReadingOrder's refs), both applies
    project it as the object model does."""
    xml, pair = _joined(form=form)
    doc = NativePageDoc(xml.encode())
    assert doc.bail is None and doc.joins == {pair}
    obj = parse_page(xml)
    page_update_higher_textequiv_levels('word', obj)
    want = obj.get_Page().get_TextRegion()[0].get_TextEquiv()[0].Unicode
    assert want == 'Auf klaerung jetzt'
    for mode in ('1', '0'):
        monkeypatch.setenv('KERASLM_NATIVE_APPLY', mode)
        out = _decode_and_serialize(NativePageDoc(xml.encode()), 'word')
        got = parse_page(out).get_Page().get_TextRegion()[0] \
            .get_TextEquiv()[0].Unicode
        assert got == want, mode


PAGES = {'phys_0001': [['Das', 'ist'], ['ein', 'Test']],
         'phys_0002': [['Ende', 'gut']]}
ALTS = {(0, 0, 0): [('D', 0.9), ('O', 0.88)],
        (1, 0, 1): [('e', 0.7), ('c', 0.69)]}
LANES = {'native': ('1', '1'), 'records': ('1', '0'), 'object': ('0', '0')}


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    return make_tiny_model(tmp_path_factory.mktemp('m') / 'model.h5')


def run_lanes(tmp_path, monkeypatch, model, pages, alts, parameter,
              lanes=LANES, edit=None, jax=True):
    """{lane: {page id: output XML}} of the port's processor on the CPU
    in each lane, and of the JAX processor (native lane, Pallas kernel
    in interpret mode) under ``'jax'``."""
    from ocrd_keraslm_tpu.wrapper import KerasRate as JKerasRate
    from ocrd_keraslm_torch.wrapper import KerasRate
    outputs = {}
    runs = [(lane, fast, nat, False) for lane, (fast, nat) in lanes.items()]
    if jax:
        runs.append(('jax', '1', '1', True))
    for lane, fast, nat, is_jax in runs:
        wdir = tmp_path / ('ws_%s' % lane)
        ws = build_workspace(wdir, pages, glyph_alternatives=alts)
        if edit is not None:
            edit(str(wdir))
        monkeypatch.setenv('KERASLM_FAST_PAGE', fast)
        monkeypatch.setenv('KERASLM_NATIVE_PAGE', nat)
        par = dict(parameter, model_file=model)
        if is_jax:
            proc = JKerasRate(workspace=ws, parameter=par)
            proc.setup()
            proc.rater.fused_decode = True
        else:
            proc = KerasRate(workspace=ws, parameter=par, device='cpu')
            proc.setup()
        page_native.pages = 0
        proc.process_workspace(ws)
        if lane == 'native':
            assert page_native.pages > 0, 'the native lane served no page'
        outputs[lane] = {
            pid: open(os.path.join(str(wdir), 'OCR-D-LM',
                                   'OCR-D-LM_%s.xml' % pid),
                      encoding='utf-8').read() for pid in pages}
    return outputs


def _contents(outputs):
    return {lane: {pid: _page_content(x) for pid, x in pages.items()}
            for lane, pages in outputs.items()}


@pytest.mark.parametrize('level', ['glyph', 'word'])
def test_processor_three_lanes_equal_jax(tmp_path, monkeypatch, tiny,
                                         level):
    outputs = run_lanes(tmp_path, monkeypatch, tiny, PAGES, ALTS,
                        {'textequiv_level': level, 'beam_width': 4})
    c = _contents(outputs)
    assert c['native'] == c['records'] == c['object'] == c['jax']
    # the two splicing lanes write the same bytes
    for pid in PAGES:
        assert _strip_ts(outputs['native'][pid]) == \
            _strip_ts(outputs['jax'][pid]), pid


def test_processor_joins_three_lanes(tmp_path, monkeypatch, tiny):
    """A cross-line join on page 1: every lane gives the same content,
    the native output keeps the Relations bytes and joins the text."""
    pages = {'phys_0001': [['Auf', 'klae'], ['rung', 'jetzt']],
             'phys_0002': [['Ende', 'gut']]}

    def edit(wdir):
        p1 = os.path.join(wdir, 'OCR-D-OCR', 'OCR-D-OCR_phys_0001.xml')
        xml = open(p1, encoding='utf-8').read()
        with open(p1, 'w', encoding='utf-8') as fh:
            fh.write(xml.replace(
                '</Page>', '<Relations><Relation type="join">'
                '<SourceRegionRef regionRef="phys_0001_r1_l0_w1"/>'
                '<TargetRegionRef regionRef="phys_0001_r1_l1_w0"/>'
                '</Relation></Relations></Page>'))
    outputs = run_lanes(tmp_path, monkeypatch, tiny, pages,
                        {(0, 0, 0): [('A', 0.9), ('O', 0.88)]},
                        {'textequiv_level': 'glyph', 'beam_width': 4},
                        edit=edit)
    c = _contents(outputs)
    assert c['native'] == c['records'] == c['object'] == c['jax']
    assert '<Relations>' in outputs['native']['phys_0001']
    text = parse_page(outputs['native']['phys_0001']).get_Page() \
        .get_TextRegion()[0].get_TextEquiv()[0].Unicode
    assert '\n' not in text, text


def test_splice_preserves_unmodeled_content(tmp_path, monkeypatch, tiny):
    from ocrd_keraslm_torch.wrapper import KerasRate

    def edit(wdir):
        path = os.path.join(wdir, 'OCR-D-OCR', 'OCR-D-OCR_phys_0001.xml')
        xml = open(path, encoding='utf-8').read()
        xml = xml.replace('<Page ', '<Page customAttr="kept" ').replace(
            '<TextRegion id="phys_0001_r1">',
            '<!-- scanned by a test --><Border><Coords points="0,0 9,9"/>'
            '</Border><TextRegion id="phys_0001_r1" orientation="0.5">'
            '<TextStyle fontSize="12.0"/>')
        with open(path, 'w', encoding='utf-8') as fh:
            fh.write(xml)
    pages = {'phys_0001': [['Das', 'ist']]}
    wdir = tmp_path / 'ws'
    ws = build_workspace(wdir, pages,
                         glyph_alternatives={(0, 0, 0): [('D', 0.9),
                                                         ('O', 0.88)]})
    edit(str(wdir))
    proc = KerasRate(workspace=ws, parameter={
        'model_file': tiny, 'beam_width': 4}, device='cpu')
    proc.setup()
    doc = proc._load_page(proc.input_files[0], 'phys_0001')
    assert isinstance(doc, NativePageDoc) and doc.bail is None
    proc.process_workspace(ws)
    out = open(os.path.join(str(wdir), 'OCR-D-LM',
                            'OCR-D-LM_phys_0001.xml'), encoding='utf-8').read()
    for kept in ('customAttr="kept"', '<Border>', 'points="0,0 9,9"',
                 'orientation="0.5"', 'fontSize="12.0"',
                 'scanned by a test', 'ocrd-keraslm-rate'):
        assert kept in out, kept
    _, content = _page_content(out)
    assert all(len(texts) == 1 for _, texts, _ in content)


def test_mixed_lanes_chain_the_carry(tmp_path, monkeypatch, tiny):
    """A page the scanner bails on (a nested region) takes the record
    lane mid-document; the carry chains across the switch and the
    output equals an all-record run and the JAX processor's."""
    pages = {'phys_0001': [['Das', 'ist']], 'phys_0002': [['ein', 'Test']],
             'phys_0003': [['Ende', 'gut']]}

    def edit(wdir):
        p2 = os.path.join(wdir, 'OCR-D-OCR', 'OCR-D-OCR_phys_0002.xml')
        xml = open(p2, encoding='utf-8').read()
        with open(p2, 'w', encoding='utf-8') as fh:
            fh.write(xml.replace(
                '<TextRegion id="phys_0002_r1">',
                '<TextRegion id="phys_0002_r1"><TextRegion id="nested">'
                '<TextEquiv><Unicode>x</Unicode></TextEquiv></TextRegion>'))
    page_native.bails = 0
    outputs = run_lanes(tmp_path, monkeypatch, tiny, pages,
                        {(0, 0, 0): [('D', 0.9), ('O', 0.88)]},
                        {'textequiv_level': 'glyph', 'beam_width': 4},
                        lanes={'native': ('1', '1'), 'records': ('1', '0')},
                        edit=edit)
    assert page_native.bails >= 1
    c = _contents(outputs)
    assert c['native'] == c['records'] == c['jax']

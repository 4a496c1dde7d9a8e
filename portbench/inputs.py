"""Seeded inputs of the benchmark: OCR-D workspaces, training corpora and
generation prompts.

Frozen copy (commit 4cfb97a) of ``chip_smoke.py``'s ``GERMAN_WORDS``,
``build_workspace``, ``write_corpus`` and ``gen_prompts``.  Changed from
there: the workspace writer builds METS and PAGE-XML with the standard
library's ElementTree instead of the port's ``wrapper/page.py`` and
``wrapper/mets.py`` classes, so the inputs do not depend on the code
under test; it also returns each page's lattice (glyph ids, alternatives
and confs in reading order, with the joining spaces and newlines), which
the reference reads instead of parsing the files again; every seed gives
a page the same number of words (each line count of the range as often,
in a seeded order) and of glyphs with alternatives (the share rounded,
their places drawn), and an alternative is never the true char twice;
a prompt is whole words of a given length in chars (1-4 words before);
the corpus's words and line lengths are drawn in bulk.
Nothing here imports the port.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Sequence, Tuple

import numpy as np

GERMAN_WORDS = (
    'der die und in den von zu das mit sich des auf für ist im dem nicht '
    'ein Die eine als auch es an werden aus er hat daß sie nach wird bei '
    'einer Der um am sind noch wie einem über einen Das so zum war haben '
    'nur oder aber vor zur bis mehr durch man sein wurde sei In Prozent '
    'hatte kann gegen vom können schon wenn habe seine Mark ihre dann '
    'unter wir soll ich eines Es Jahr zwei Jahren diese dieser wieder '
    'keine Uhr seiner worden Und will zwischen Im immer Millionen Ein was '
    'sagte Er gibt alle DM diesem seit muß wurden beim doch jetzt waren '
    'drei Jahre Mit neue neuen damit bereits da Auf ihr seinen müssen ab '
    'ihrer Nach ohne sondern selbst ersten nun etwa Bei heute ihren weil '
    'ihm Menschen Deutschland anderen werde Ich sagt Sie Frau Herr Kinder '
    'Vernunft Aufklärung Mensch Natur Geist Zeit Welt Leben Stadt König '
    'Kirche Schule Arbeit Recht Wahrheit Freiheit Glück Liebe Gott').split()

PAGE_NS = 'http://schema.primaresearch.org/PAGE/gts/pagecontent/2019-07-15'
METS_NS = 'http://www.loc.gov/METS/'
MODS_NS = 'http://www.loc.gov/mods/v3'
XLINK_NS = 'http://www.w3.org/1999/xlink'
MIMETYPE_PAGE = 'application/vnd.prima.page+xml'
INPUT_GRP = 'OCR-D-OCR'

# one lattice position: (glyph id or None for a joining space/newline,
# ((char, conf), ...) in TextEquiv index order)
Position = Tuple[object, Tuple[Tuple[str, float], ...]]


def words_in(charset) -> List[str]:
    return [w for w in GERMAN_WORDS if set(w) <= set(charset)]


def _te(parent, unicode, conf, index=None):
    te = ET.SubElement(parent, '{%s}TextEquiv' % PAGE_NS)
    if index is not None:
        te.set('index', str(index))
    te.set('conf', repr(float(conf)))
    ET.SubElement(te, '{%s}Unicode' % PAGE_NS).text = unicode


def line_sizes(rng: np.random.Generator, n_lines: int, lo: int, hi: int
               ) -> List[int]:
    """Words of each of ``n_lines`` lines: the counts ``lo``..``hi - 1``
    in turn, shuffled, so that every seed gives a page the same number of
    words."""
    sizes = [lo + i % (hi - lo) for i in range(n_lines)]
    return [sizes[int(i)] for i in rng.permutation(n_lines)]


def build_workspace(directory: str, rng: np.random.Generator, n_pages: int,
                    n_lines: int, charset, alt_share: float = 0.15,
                    identifier: str = 'urn:portbench/doc_1784',
                    line_words: Sequence[Tuple[int, int]] = ((8, 13),)
                    ) -> List[List[Position]]:
    """A METS/PAGE workspace of German-like text over ``charset``: one
    region per page, ``n_lines`` lines of words (page p: ``line_words[p %
    len(line_words)]`` gives the range, upper bound excluded, each count
    as often), one Glyph per char; ``alt_share`` of a page's glyphs
    (rounded) carry 2-4 alternatives (the true char among them, confs
    0.75-0.84, sorted), the others one at 0.95.  Returns each page's
    lattice positions in reading order."""
    ET.register_namespace('', PAGE_NS)
    words = words_in(charset)
    letters = sorted(c for c in charset if c.isalpha())
    os.makedirs(os.path.join(directory, INPUT_GRP), exist_ok=True)
    pages: List[List[Position]] = []
    files = []
    for p in range(n_pages):
        page_id = 'phys_%04d' % (p + 1)
        lo, hi = line_words[p % len(line_words)]
        lines = []
        for n_words in line_sizes(rng, n_lines, lo, hi):
            texts = []
            for _ in range(n_words):
                text = words[int(rng.integers(len(words)))]
                if rng.random() < 0.1:
                    text += ',' if ',' in charset else ''
                texts.append(text)
            lines.append(texts)
        n_glyphs = sum(len(t) for texts in lines for t in texts)
        with_alts = set(rng.choice(n_glyphs, int(round(alt_share * n_glyphs)),
                                   replace=False).tolist())
        root = ET.Element('{%s}PcGts' % PAGE_NS, pcGtsId=page_id)
        meta = ET.SubElement(root, '{%s}Metadata' % PAGE_NS)
        ET.SubElement(meta, '{%s}Creator' % PAGE_NS).text = 'portbench'
        ET.SubElement(meta, '{%s}Created' % PAGE_NS).text = \
            '2026-01-01T00:00:00'
        ET.SubElement(meta, '{%s}LastChange' % PAGE_NS).text = \
            '2026-01-01T00:00:00'
        page = ET.SubElement(root, '{%s}Page' % PAGE_NS, imageFilename='',
                             imageWidth='0', imageHeight='0')
        region = ET.SubElement(page, '{%s}TextRegion' % PAGE_NS,
                               id='%s_r1' % page_id)
        positions: List[Position] = []
        g = 0
        for li, texts in enumerate(lines):
            line = ET.SubElement(region, '{%s}TextLine' % PAGE_NS,
                                 id='%s_l%d' % (page_id, li))
            for wi, text in enumerate(texts):
                if wi > 0:
                    positions.append((None, ((' ', 1.0),)))
                elif li > 0:
                    positions.append((None, (('\n', 1.0),)))
                word_id = '%s_l%d_w%d' % (page_id, li, wi)
                word = ET.SubElement(line, '{%s}Word' % PAGE_NS, id=word_id)
                for gi, char in enumerate(text):
                    gid = '%s_g%d' % (word_id, gi)
                    glyph = ET.SubElement(word, '{%s}Glyph' % PAGE_NS,
                                          id=gid)
                    if g in with_alts:
                        n_alt = int(rng.integers(2, 5))
                        others = [c for c in letters if c != char]
                        cands = [char] + [others[int(i)] for i in
                                          rng.choice(len(others),
                                                     n_alt - 1,
                                                     replace=False)]
                        order = rng.permutation(n_alt)
                        confs = np.sort(rng.uniform(0.75, 0.84, n_alt))[::-1]
                        alts = tuple((cands[o], float(round(c, 4)))
                                     for o, c in zip(order, confs))
                    else:
                        alts = ((char, 0.95),)
                    g += 1
                    for idx, (u, c) in enumerate(alts):
                        _te(glyph, u, c, idx)
                    positions.append((gid, alts))
                _te(word, text, 0.9)
            _te(line, ' '.join(texts), 0.9)
        _te(region, '\n'.join(' '.join(t) for t in lines), 0.9)
        fid = '%s_%s' % (INPUT_GRP, page_id)
        fname = os.path.join(INPUT_GRP, fid + '.xml')
        ET.ElementTree(root).write(os.path.join(directory, fname),
                                   encoding='UTF-8', xml_declaration=True)
        files.append((fid, fname, page_id))
        pages.append(positions)
    write_mets(directory, identifier, files)
    return pages


def mets_xml(identifier: str, files) -> bytes:
    """METS with a MODS identifier and one PAGE file per page."""
    for prefix, uri in (('mets', METS_NS), ('mods', MODS_NS),
                        ('xlink', XLINK_NS)):
        ET.register_namespace(prefix, uri)
    m = '{%s}' % METS_NS
    root = ET.Element(m + 'mets')
    dmd = ET.SubElement(root, m + 'dmdSec', ID='DMDLOG_0000')
    wrap = ET.SubElement(dmd, m + 'mdWrap', MDTYPE='MODS')
    data = ET.SubElement(wrap, m + 'xmlData')
    mods = ET.SubElement(data, '{%s}mods' % MODS_NS)
    ET.SubElement(mods, '{%s}identifier' % MODS_NS,
                  type='purl').text = identifier
    sec = ET.SubElement(root, m + 'fileSec')
    grp = ET.SubElement(sec, m + 'fileGrp', USE=INPUT_GRP)
    for fid, fname, _ in files:
        f = ET.SubElement(grp, m + 'file', ID=fid, MIMETYPE=MIMETYPE_PAGE)
        loc = ET.SubElement(f, m + 'FLocat', LOCTYPE='OTHER',
                            OTHERLOCTYPE='FILE')
        loc.set('{%s}href' % XLINK_NS, fname)
    smap = ET.SubElement(root, m + 'structMap', TYPE='PHYSICAL')
    seq = ET.SubElement(smap, m + 'div', TYPE='physSequence')
    for fid, _, page_id in files:
        div = ET.SubElement(seq, m + 'div', TYPE='page', ID=page_id)
        ET.SubElement(div, m + 'fptr', FILEID=fid)
    return ET.tostring(root, encoding='UTF-8', xml_declaration=True)


def write_mets(directory: str, identifier: str, files) -> None:
    with open(os.path.join(directory, 'mets.xml'), 'wb') as fh:
        fh.write(mets_xml(identifier, files))


def read_glyphs(path: str) -> Dict[str, List[Tuple[str, float]]]:
    """{glyph id: [(Unicode, conf), ...]} of one PAGE-XML file."""
    out = {}
    p = '{%s}' % PAGE_NS
    for glyph in ET.parse(path).getroot().iter(p + 'Glyph'):
        tes = []
        for te in glyph.findall(p + 'TextEquiv'):
            u = te.find(p + 'Unicode')
            conf = te.get('conf')
            tes.append((u.text if u is not None and u.text else '',
                        float(conf) if conf is not None else float('nan')))
        out[glyph.get('id')] = tes
    return out


def write_corpus(directory: str, rng: np.random.Generator,
                 sizes: Dict[str, int]) -> List[str]:
    """Seeded German-like text files ``{name: chars}`` (lines of 8-12
    words, the words and the line lengths drawn in bulk); returns their
    paths."""
    os.makedirs(directory, exist_ok=True)
    words = np.array(GERMAN_WORDS)
    mean_line = 10 * (np.mean([len(w) for w in GERMAN_WORDS]) + 1)
    paths = []
    for name, n_chars in sizes.items():
        parts, total = [], 0
        while total < n_chars:
            n_lines = int((n_chars - total) / mean_line) + 16
            counts = rng.integers(8, 13, size=n_lines)
            tokens = words[rng.integers(len(words), size=int(counts.sum()))]
            ends = np.zeros(len(tokens), bool)
            ends[np.cumsum(counts) - 1] = True
            seps = np.where(ends, '\n', ' ')
            chunk = ''.join(np.char.add(tokens, seps).tolist())
            parts.append(chunk)
            total += len(chunk)
        path = os.path.join(directory, name)
        with open(path, 'w', encoding='utf-8') as fh:
            fh.write(''.join(parts)[:n_chars])
        paths.append(path)
    return paths


def prompt(rng: np.random.Generator, charset, n_chars: int) -> str:
    """A German-like prompt of exactly ``n_chars`` chars: whole words,
    each followed by a space; words drawn one by one while more than 14
    chars are left, then one or two drawn among those that fill the
    rest (all drawn again where none does)."""
    words = words_in(charset)
    while True:
        out, left = [], n_chars
        while left > 14:
            w = words[int(rng.integers(len(words)))]
            out.append(w)
            left -= len(w) + 1
        fills = [(a,) for a in words if len(a) + 1 == left] + [
            (a, b) for a in words for b in words
            if len(a) + len(b) + 2 == left]
        if fills:
            out += fills[int(rng.integers(len(fills)))]
            return ' '.join(out) + ' '

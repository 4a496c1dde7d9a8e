"""Native-lane PAGE document: byte scan, array lattice, splice output.

The processor's default lane for device decoding at word or glyph
level (``KERASLM_NATIVE_PAGE``, default ``1``): the C++ scanner
(``native_src/page_scan.cpp``, built by :mod:`ocrd_keraslm_torch.native`)
reads the raw XML bytes once into flat structure arrays, byte spans and
a decoded text blob, builds the linear lattice and fills the decode
kernel's (E, A, L) arrays directly: no per-glyph Python object exists
at any point.  Results are written back by splicing the original bytes
(loser TextEquiv spans dropped, winner conf values patched, projected
higher-level TextEquivs inserted before the closing tags), so all
unmodeled content survives verbatim.

Counterpart of ``ocrd_keraslm_tpu/wrapper/page_native.py``.  Semantics
are those of the ElementTree record lane (``page_fast``) and the object
model (``page``), held together by ``tests/test_torch_page_native.py``.
Any input the scanner does not provably handle (a DOCTYPE internal
subset, unknown entities, non-UTF-8, nested regions, line or region
level, missing Metadata) sets ``bail``; the processor then takes the
record lane for that page, counts the bail in :data:`bails` and logs
the reason.  A flat page's ReadingOrder is inert and skipped;
``Relation type=join`` pairs are collected and honored by the
projection.

Reference semantics: lattice wrapper/rate.py:343-424 (in C++),
write-back and projection wrapper/rate.py:426-590 (here, on arrays).
"""
from __future__ import annotations

import ctypes
import datetime
import logging
import os
import re
import threading
from typing import Dict, List, Optional

import numpy as np

from .. import native
from .page import MetadataItem

LOG = logging.getLogger(__name__)

# plain counters beside the kernels' ``launches``: documents the scanner
# or the lattice builder bailed on, pages the processor decoded through
# this lane (alone or in a page group), and page-group launches
bails = 0
pages = 0
groups = 0
_BAILS_LOCK = threading.Lock()

_LEVEL_INT = {'word': 2, 'glyph': 3}

_ENT = {'amp': '&', 'lt': '<', 'gt': '>', 'quot': '"', 'apos': "'"}
_ENT_RE = re.compile(r'&(#x?[0-9a-fA-F]+|[a-z]+);')


def _unesc(raw: str) -> str:
    """Resolve XML entities in an attribute value (raw byte span)."""
    def sub(m):
        e = m.group(1)
        if e.startswith('#x') or e.startswith('#X'):
            return chr(int(e[2:], 16))
        if e.startswith('#'):
            return chr(int(e[1:]))
        return _ENT.get(e, m.group(0))
    return _ENT_RE.sub(sub, raw)


def _esc(text: str) -> str:
    return (text.replace('&', '&amp;').replace('<', '&lt;')
            .replace('>', '&gt;'))


def _esc_attr(text: str) -> str:
    return _esc(text).replace('"', '&quot;')


def available() -> bool:
    """Whether the lane can serve: False only with ``KERASLM_NATIVE=0``
    (a failed build raises)."""
    return native.load_page_scan() is not None


def _bail(doc, reason):
    global bails
    with _BAILS_LOCK:   # the processor scans in its prefetch thread too
        bails += 1
    doc.bail = reason
    LOG.info('native page lane bailed: %s', reason)


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativePageDoc:
    """One PAGE document in the native lane.

    Lifecycle: construct (scan) -> ``lattice``/``fill`` (decode
    arrays) -> ``apply_decode`` (winners + projection as splice edits)
    -> ``set_pcGtsId``/``add_metadata_item`` -> ``fast_tostring``
    (page.to_xml dispatches here) assembles the output bytes.
    ``bail`` is non-None whenever the lane cannot serve the document.
    """

    def __init__(self, source):
        self.bail: Optional[str] = None
        lib = native.load_page_scan()
        if lib is None:
            _bail(self, 'native scanner unavailable')
            return
        if isinstance(source, bytes):
            data = source
        else:
            with open(source, 'rb') as fh:
                data = fh.read()
        self._lib = lib
        self.data = data
        self.cap = lib.page_open(data, len(data))
        bail = lib.page_bail(self.cap)
        self._joins = None  # lazy Relation type=join (src, tgt) set
        self._edits: List = []       # (start, end, replacement bytes)
        self._meta_items: List[MetadataItem] = []
        self._pcgtsid_override: Optional[str] = None
        self._native_applied = False  # edits live doc-side (page_emit)
        self._lat = None
        if bail is not None:
            _bail(self, bail)
            return
        (self.n_els, self.n_tes, self.text_blob, self.id_blob,
         self.page_rd, self.page_tlo,
         (self.pcgtsid_s, self.pcgtsid_e), self.root_tag_insert,
         self.root_content_start,
         (self.lastchange_s, self.lastchange_e), self.meta_insert,
         created_missing, creator_missing) = lib.page_counts(self.cap)
        if self.meta_insert < 0 or self.lastchange_s < 0 or \
                created_missing or creator_missing:
            # the object path re-emits a complete Metadata block; keep
            # output parity by leaving incomplete metadata to that path
            _bail(self, 'incomplete Metadata')
            return
        n, m = self.n_els, self.n_tes
        self.ekind = np.zeros(n, np.int8)
        self.eparent = np.zeros(n, np.int32)
        self.erd = np.zeros(n, np.int8)
        self.etlo = np.zeros(n, np.int8)
        self.econtent_end = np.zeros(n, np.int64)
        self.espan = np.zeros((n, 2), np.int64)
        self.eself = np.zeros(n, np.int8)
        self.eid = np.zeros((n, 2), np.int64)
        self.efirst_te = np.zeros(n, np.int32)
        self.towner = np.zeros(m, np.int32)
        self.tconf = np.zeros(m, np.float64)
        self.tindex = np.zeros(m, np.int32)
        self.tspan = np.zeros((m, 2), np.int64)
        self.tconf_span = np.zeros((m, 2), np.int64)
        self.ttag_insert = np.zeros(m, np.int64)
        self.ttext = np.zeros((m, 2), np.int64)
        rc = lib.page_arrays(
            self.cap,
            _ptr(self.ekind, ctypes.c_int8),
            _ptr(self.eparent, ctypes.c_int32),
            _ptr(self.erd, ctypes.c_int8),
            _ptr(self.etlo, ctypes.c_int8),
            _ptr(self.econtent_end, ctypes.c_int64),
            _ptr(self.espan, ctypes.c_int64),
            _ptr(self.eself, ctypes.c_int8),
            _ptr(self.eid, ctypes.c_int64),
            _ptr(self.efirst_te, ctypes.c_int32),
            _ptr(self.towner, ctypes.c_int32),
            _ptr(self.tconf, ctypes.c_double),
            _ptr(self.tindex, ctypes.c_int32),
            _ptr(self.tspan, ctypes.c_int64),
            _ptr(self.tconf_span, ctypes.c_int64),
            _ptr(self.ttag_insert, ctypes.c_int64),
            _ptr(self.ttext, ctypes.c_int64))
        if rc != 0:
            _bail(self, 'array extraction failed')

    # -- PcGts surface the processor touches ---------------------------

    def get_pcGtsId(self):
        if self._pcgtsid_override is not None:
            return self._pcgtsid_override
        if self.pcgtsid_e > self.pcgtsid_s:
            return _unesc(self.data[self.pcgtsid_s:self.pcgtsid_e]
                          .decode('utf-8'))
        return None

    def set_pcGtsId(self, value):
        self._pcgtsid_override = value

    def add_metadata_item(self, item: MetadataItem):
        self._meta_items.append(item)

    @property
    def joins(self):
        """Relation type=join (srcRef, tgtRef) pairs as a set — the
        projection suppresses the newline between consecutive lines
        whose boundary word ids form such a pair."""
        if self._joins is None:
            self._joins = set(map(tuple,
                                  self._lib.page_joins(self.cap)))
        return self._joins

    def te_text(self, ti: int) -> str:
        s, e = self.ttext[ti]
        return self.text_blob[s:e]

    def elem_id(self, ei: int) -> str:
        s, e = self.eid[ei]
        return self.id_blob[s:e]

    def to_fast(self):
        """Re-parse through the ElementTree record lane (``page_fast``),
        for a page this lane does not serve."""
        from .page_fast import parse_page_fast
        return parse_page_fast(self.data)

    # -- lattice / decode arrays ---------------------------------------

    def lattice(self, level: str, merge: bool, merge_max: int):
        """Build the linear lattice; returns (n_raw, n_prep, maxlen)
        or None when the lane cannot serve this document/level."""
        lvl = _LEVEL_INT.get(level)
        if lvl is None or self.bail is not None:
            return None
        out = self._lib.page_lattice(self.cap, lvl, int(merge),
                                     merge_max)
        if isinstance(out, str):
            _bail(self, out)
            return None
        n_raw, n_prep, maxlen, n_pieces, n_warn, n_problems = out
        if n_warn:
            LOG.warning('%d elements without text results/children '
                        'skipped', n_warn)
        if n_problems:
            LOG.warning('%d tokenisation inconsistencies detected '
                        '(joining spaces repaired where the annotated '
                        'text concatenates)', n_problems)
        self._lat = (n_raw, n_prep, maxlen, n_pieces)
        return n_raw, n_prep, maxlen

    def fill(self, table: np.ndarray, E: int, A: int, L: int):
        """Fill the decode-kernel arrays + emission meta arrays."""
        n_raw, n_prep, maxlen, n_pieces = self._lat
        table = np.ascontiguousarray(table, np.int32)
        chars = np.zeros((E, A, L), np.int32)
        mask = np.zeros((E, A, L), np.float32)
        conf = np.zeros((E, A, L), np.float32)
        valid = np.zeros((E, A), np.float32)
        self.edge_kind = np.zeros(n_prep, np.int8)
        self.edge_elem = np.zeros(n_prep, np.int32)
        self.alt_te = np.zeros((n_prep, 4), np.int32)
        self.alt_len = np.zeros((n_prep, 4), np.int32)
        self.piece_edge = np.zeros(n_pieces, np.int32)
        self.piece_elem = np.zeros(n_pieces, np.int32)
        self.piece_te = np.zeros(n_pieces, np.int32)
        self.piece_len = np.zeros(n_pieces, np.int32)
        rc = self._lib.page_fill(
            self.cap, _ptr(table, ctypes.c_int32), len(table),
            E, A, L,
            _ptr(chars, ctypes.c_int32), _ptr(mask, ctypes.c_float),
            _ptr(conf, ctypes.c_float), _ptr(valid, ctypes.c_float),
            _ptr(self.edge_kind, ctypes.c_int8),
            _ptr(self.edge_elem, ctypes.c_int32),
            _ptr(self.alt_te, ctypes.c_int32),
            _ptr(self.alt_len, ctypes.c_int32),
            _ptr(self.piece_edge, ctypes.c_int32),
            _ptr(self.piece_elem, ctypes.c_int32),
            _ptr(self.piece_te, ctypes.c_int32),
            _ptr(self.piece_len, ctypes.c_int32))
        if rc != n_prep:
            raise RuntimeError('native page fill failed')
        return chars, mask, conf, valid

    # -- decode write-back + projection --------------------------------

    def apply_decode(self, level: str, choices, costs, start_cost,
                     logger=None):
        """Per-element winners + confidence scores from the walked
        device result, then higher-level text projection — all as
        splice edits.  Logs the avg/char-ppl/level-ppl line the tests
        parse (replica of wrapper/rate.py _page_update_from_path +
        page_update_higher_textequiv_levels).

        Runs in C++ (``page_apply``, edits stored doc-side for
        ``page_emit``) unless ``KERASLM_NATIVE_APPLY=0``; the Python
        body below remains the parity-tested reference and the
        fallback."""
        logger = logger or LOG
        n_raw, n_prep, maxlen, n_pieces = self._lat
        if os.environ.get('KERASLM_NATIVE_APPLY') != '0':
            ch = np.ascontiguousarray(
                np.asarray(choices[:n_prep]), np.int64)
            co = np.ascontiguousarray(
                np.asarray(costs[:n_prep]), np.float64)
            # pass the REAL lengths so the C++ short-result guard can
            # fire (a truncated decode then falls through to the
            # Python path's clean IndexError instead of an OOB read)
            out = self._lib.page_apply(
                self.cap, _LEVEL_INT[level],
                _ptr(ch, ctypes.c_int64), _ptr(co, ctypes.c_double),
                min(len(ch), len(co)), float(start_cost))
            if not isinstance(out, str):
                strlen, n_path = out
                if strlen:
                    entropy = (float(co[-1]) - start_cost) / strlen
                    logger.info(
                        'avg: %.3f, char ppl: %.3f, %s ppl: %.3f',
                        2.0 ** (-entropy), 2.0 ** entropy, level,
                        2.0 ** (entropy * strlen / max(n_path, 1)))
                self._native_applied = True
                return
            logger.debug('native page_apply bailed (%s): python '
                         'apply', out)
        choices = np.asarray(choices[:n_prep], np.int64)
        costs = np.asarray(costs[:n_prep], np.float64)
        diffs = np.diff(np.concatenate(([start_cost], costs)))

        winner_te = np.full(self.n_els, -1, np.int64)
        winner_score = np.zeros(self.n_els, np.float64)
        strlen = 0
        n_path = 0

        # merged runs: uniform per-char score over the run
        if n_pieces:
            run_total = np.zeros(n_prep, np.float64)
            np.add.at(run_total, self.piece_edge, self.piece_len)
            run_score = np.minimum(
                2.0 ** (-diffs[self.piece_edge] /
                        np.maximum(run_total[self.piece_edge], 1)),
                1.0)
            pe_elem = self.piece_elem
            has_el = pe_elem >= 0
            winner_te[pe_elem[has_el]] = self.piece_te[has_el]
            winner_score[pe_elem[has_el]] = run_score[has_el]
            # real char counts: te span length for element pieces,
            # 1 per synthetic space piece
            el_tes = self.piece_te[has_el]
            strlen += int((self.ttext[el_tes, 1] -
                           self.ttext[el_tes, 0]).sum())
            strlen += int((~has_el).sum())
            n_path += n_pieces

        plain = self.edge_kind == 0
        if plain.any():
            pk = np.nonzero(plain)[0]
            n_alts = (self.alt_te[pk] != -2).sum(axis=1)
            ai = np.minimum(choices[pk], np.maximum(n_alts - 1, 0))
            te = self.alt_te[pk, ai]
            ln = self.alt_len[pk, ai]
            score = np.minimum(
                2.0 ** (-diffs[pk] / np.maximum(ln, 1)), 1.0)
            elem = self.edge_elem[pk]
            has_el = elem >= 0
            winner_te[elem[has_el]] = te[has_el]
            winner_score[elem[has_el]] = score[has_el]
            strlen += int(ln[has_el].sum())
            strlen += int((~has_el).sum())  # spaces count 1 char
            n_path += len(pk)

        if strlen:
            entropy = (float(costs[-1]) - start_cost) / strlen
            avg = 2.0 ** (-entropy)
            ppl = 2.0 ** entropy
            ppll = 2.0 ** (entropy * strlen / max(n_path, 1))
            logger.info('avg: %.3f, char ppl: %.3f, %s ppl: %.3f',
                        avg, ppl, level, ppll)

        edits = self._edits
        decoded = winner_te >= 0
        # loser TextEquiv spans: owner decoded, te is not the winner
        owner_decoded = decoded[self.towner]
        loser = owner_decoded & \
            (winner_te[self.towner] != np.arange(self.n_tes))
        for s, e in self.tspan[loser]:
            edits.append((int(s), int(e), b''))
        # winner conf := score ('%.6g', the shared emit format)
        widx = np.nonzero(decoded)[0]
        wte = winner_te[widx]
        scores = winner_score[widx]
        score_b = [('%.6g' % s).encode() for s in scores]
        cs = self.tconf_span[wte]
        ti_ins = self.ttag_insert[wte]
        for k in range(len(widx)):
            s, e = cs[k]
            if e > s:
                edits.append((int(s), int(e), score_b[k]))
            else:
                edits.append((int(ti_ins[k]), int(ti_ins[k]),
                              b' conf="' + score_b[k] + b'"'))

        self._project(level, winner_te, winner_score, decoded)

    def _project(self, level, winner_te, winner_score, decoded):
        """Recompute word/line/region texts from the decoded winners
        (replica of page_update_higher_textequiv_levels without nested
        regions, which bail at scan; a flat page's ReadingOrder is
        inert — the projection only consults reading order for nested
        subregions.  Relation type=join pairs ARE honored: they
        suppress the newline between joined consecutive lines).

        Vectorized per-element data (winner-or-first te, confidence,
        effective layout directives, children grouping) — the Python
        loops touch only the ~word/line/region counts, not glyphs."""
        kind = self.ekind
        parent = self.eparent.astype(np.int64)
        n = self.n_els
        regions = np.nonzero(kind == 0)[0]
        blob = self.text_blob
        tt = self.ttext

        # winner-or-first te and effective conf per element (the
        # page_element_unicode0/conf0 fallback for undecoded elements)
        te_of = np.where(decoded, winner_te,
                         self.efirst_te.astype(np.int64))
        ft = np.maximum(self.efirst_te, 0)
        ft_conf = self.tconf[ft]
        ft_conf = np.where(np.isnan(ft_conf), 1.0, ft_conf)
        ft_conf = np.where(self.efirst_te >= 0, ft_conf, 1.0)
        conf_of = np.where(decoded, winner_score, ft_conf)

        # 'or'-chain of layout attributes: first PRESENT value wins,
        # falling through missing (0) ancestors to the page default
        def effective(attr, page_val):
            eff = attr.astype(np.int64)
            anc = parent
            for _ in range(3):  # word -> line -> region
                take = (eff == 0) & (anc >= 0)
                if not take.any():
                    break
                eff = np.where(take, attr[np.maximum(anc, 0)], eff)
                anc = np.where(anc >= 0, parent[np.maximum(anc, 0)],
                               -1)
            return np.where(eff == 0, page_val, eff) == 1

        is_rtl = effective(self.erd, self.page_rd)
        is_btt = effective(self.etlo, self.page_tlo)

        # document-order children per parent (stable argsort keeps
        # ascending element index = document order within a parent)
        corder = np.argsort(parent, kind='stable')
        cbounds = np.searchsorted(parent[corder], np.arange(n + 1))

        def children(p):
            return corder[cbounds[p]:cbounds[p + 1]]

        def el_text(ei):
            ti = te_of[ei]
            return blob[tt[ti, 0]:tt[ti, 1]] if ti >= 0 else ''

        edits = self._edits
        new_text: Dict[int, str] = {}
        new_conf: Dict[int, float] = {}

        def cur_text(e):
            e = int(e)
            return new_text[e] if e in new_text else el_text(e)

        def cur_conf(e):
            e = int(e)
            return new_conf[e] if e in new_conf else float(conf_of[e])
        # per-element own-te spans, grouped once (a per-call
        # towner == ei scan would be O(elements x tes))
        te_order = np.argsort(self.towner, kind='stable')
        te_bounds = np.searchsorted(self.towner[te_order],
                                    np.arange(self.n_els + 1))

        def set_te(ei, text, conf):
            """Replace an element's own TextEquivs with one projected
            result (delete old spans, insert a fresh fragment)."""
            new_text[ei] = text
            new_conf[ei] = conf
            own = te_order[te_bounds[ei]:te_bounds[ei + 1]]
            for s, e in self.tspan[own]:
                edits.append((int(s), int(e), b''))
            frag = ('<TextEquiv conf="%.6g"><Unicode>%s</Unicode>'
                    '</TextEquiv>' % (conf, _esc(text))).encode()
            if self.eself[ei]:
                # self-closing element: reopen it around the fragment
                # (a '<Tag .../>' span always ends with the two bytes
                # '/>'; XML forbids whitespace between them).  The tag
                # NAME ends at any XML whitespace — including tab/CR/LF
                # from pretty-printed attributes — or '/' or '>'.
                s, e = self.espan[ei]
                tag = self.data[s:e]
                name = re.split(br'[ \t\r\n/>]', tag[1:],
                                maxsplit=1)[0]
                edits.append((int(s), int(e),
                              tag[:-2] + b'>' + frag +
                              b'</' + name + b'>'))
            else:
                p = int(self.econtent_end[ei])
                edits.append((p, p, frag))

        for ri in regions:
            lines = children(ri)
            if is_btt[ri]:
                lines = lines[::-1]
            if level != 'line':
                for li in lines:
                    words = children(li)
                    if is_rtl[li]:
                        words = words[::-1]
                    if level != 'word':
                        for wi in words:
                            glyphs = children(wi)
                            if is_rtl[wi]:
                                glyphs = glyphs[::-1]
                            tis = te_of[glyphs]
                            text = ''.join(
                                blob[tt[ti, 0]:tt[ti, 1]]
                                for ti in tis if ti >= 0)
                            # sequential sum in glyph order, NOT
                            # numpy's pairwise .sum(): the native
                            # page_apply accumulates sequentially and
                            # the two differ in the last ulp for >= 8
                            # glyphs, which can flip a %.6g boundary
                            # and break native/Python byte parity
                            conf = (sum(float(conf_of[g])
                                        for g in glyphs) / len(glyphs)
                                    if len(glyphs) else 0.0)
                            set_te(int(wi), text, conf)
                    line_text = ' '.join(cur_text(w) for w in words)
                    line_conf = sum(cur_conf(w) for w in words)
                    if len(words):
                        line_conf /= len(words)
                    set_te(int(li), line_text, line_conf)
            joins = self.joins
            if joins:
                # Relation type=join: no newline between consecutive
                # lines whose boundary WORD ids (document order, like
                # the record lane's line.get_Word()) form a join pair
                parts = []
                for k, li in enumerate(lines):
                    if k:
                        pw = children(lines[k - 1])
                        nw = children(li)
                        if not (len(pw) and len(nw) and
                                (self.elem_id(int(pw[-1])),
                                 self.elem_id(int(nw[0]))) in joins):
                            parts.append('\n')
                    parts.append(cur_text(li))
                region_text = ''.join(parts)
            else:
                region_text = '\n'.join(cur_text(li) for li in lines)
            region_conf = 0.0
            if len(lines):
                region_conf = sum(cur_conf(li)
                                  for li in lines) / len(lines)
            set_te(int(ri), region_text, region_conf)

    # -- serialization --------------------------------------------------

    def fast_tostring(self) -> str:
        """Assemble the output bytes: original document spliced with
        the queued edits (decode write-back, projection, metadata,
        pcGtsId).  Dispatched by page.to_xml.  After a native
        ``page_apply`` the decode/projection edits live doc-side and
        ``page_emit`` splices everything in C++; otherwise the Python
        splice below runs."""
        edits = list(self._edits)
        now = datetime.datetime.now().isoformat()
        edits.append((int(self.lastchange_s), int(self.lastchange_e),
                      now.encode()))
        if self._meta_items:
            frags = []
            for item in self._meta_items:
                parts = ['<MetadataItem type="%s"'
                         % _esc_attr(item.type)]
                if item.name:
                    parts.append(' name="%s"' % _esc_attr(item.name))
                if item.value:
                    parts.append(' value="%s"' % _esc_attr(item.value))
                parts.append('>')
                for group, labels in item.labels.items():
                    parts.append('<Labels')
                    if group:
                        parts.append(' comments="%s"'
                                     % _esc_attr(group))
                    parts.append('>')
                    for k, v in labels.items():
                        parts.append('<Label type="%s" value="%s"/>'
                                     % (_esc_attr(k),
                                        _esc_attr(str(v))))
                    parts.append('</Labels>')
                parts.append('</MetadataItem>')
                frags.append(''.join(parts))
            p = int(self.meta_insert)
            edits.append((p, p, ''.join(frags).encode()))
        if self._pcgtsid_override is not None:
            vb = _esc_attr(self._pcgtsid_override).encode()
            if self.pcgtsid_e > self.pcgtsid_s:
                edits.append((int(self.pcgtsid_s),
                              int(self.pcgtsid_e), vb))
            else:
                p = int(self.root_tag_insert)
                edits.append((p, p, b' pcGtsId="' + vb + b'"'))
        if self._native_applied:
            out = self._lib.page_emit(self.cap, edits)
            if isinstance(out, str):
                raise RuntimeError('native page_emit: %s' % out)
            return out.decode('utf-8')
        edits.sort(key=lambda t: (t[0], t[1]))
        out = []
        pos = 0
        data = self.data
        for s, e, rep in edits:
            if s < pos:
                raise RuntimeError('overlapping splice edits '
                                   '(%d < %d)' % (s, pos))
            out.append(data[pos:s])
            out.append(rep)
            pos = e
        out.append(data[pos:])
        return b''.join(out).decode('utf-8')

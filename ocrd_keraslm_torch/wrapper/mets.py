"""Minimal METS workspace (standalone ocrd-core replacement).

The reference delegates workspace handling to ocrd core (Workspace,
OcrdMets).  This module implements the subset the processor needs
against a plain directory with a ``mets.xml``:

* list files of a fileGrp with page association (structMap physical),
* the METS unique identifier (mods:identifier) used for the year
  context (reference wrapper/rate.py:328-341),
* adding output files (payload write + fileSec/structMap update),
* (de)serialization.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import xml.etree.ElementTree as etree

from .page import tostring, xml_parser

METS_NS = 'http://www.loc.gov/METS/'
XLINK_NS = 'http://www.w3.org/1999/xlink'
MODS_NS = 'http://www.loc.gov/mods/v3'
for _prefix, _uri in (('mets', METS_NS), ('xlink', XLINK_NS),
                     ('mods', MODS_NS)):
    etree.register_namespace(_prefix, _uri)
_M = '{%s}' % METS_NS
_X = '{%s}' % XLINK_NS
_MODS = '{%s}' % MODS_NS

MIMETYPE_PAGE = 'application/vnd.prima.page+xml'


@dataclass
class MetsFile:
    ID: str
    fileGrp: str
    mimetype: str = MIMETYPE_PAGE
    local_filename: Optional[str] = None
    pageId: Optional[str] = None

    @property
    def basename(self):
        return os.path.basename(self.local_filename or '')


@dataclass
class Mets:
    unique_identifier: Optional[str] = None
    file_groups: Dict[str, List[MetsFile]] = field(default_factory=dict)
    # page order: list of (physical page ID)
    page_ids: List[str] = field(default_factory=list)
    # the ORIGINAL parsed document (None for fresh workspaces):
    # serialization updates it IN PLACE so every METS section this
    # model does not represent (metsHdr/agents, amdSec, LOGICAL
    # structMap, structLink, div ORDER/ORDERLABEL, custom attributes)
    # survives a save verbatim — regenerating from the minimal model
    # destroyed real workspaces' provenance
    root: Optional[etree.Element] = field(default=None, repr=False,
                                           compare=False)

    def find_files(self, ID=None, fileGrp=None, pageId=None):
        for grp, files in self.file_groups.items():
            if fileGrp and grp != fileGrp:
                continue
            for f in files:
                if ID and f.ID != ID:
                    continue
                if pageId and f.pageId != pageId:
                    continue
                yield f


class Workspace:
    """A directory with a mets.xml and file-group subdirectories."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        self.mets_path = os.path.join(self.directory, 'mets.xml')
        self.mets = (parse_mets(self.mets_path)
                     if os.path.exists(self.mets_path) else Mets())

    def download_file(self, f: MetsFile) -> MetsFile:
        """Resolve a file for local reading: a workspace's files are
        local already, so this returns ``f`` unchanged."""
        return f

    def add_file(self, file_grp: str, ID: str, pageId: Optional[str],
                 local_filename: str, mimetype: str = MIMETYPE_PAGE,
                 content: Optional[str] = None,
                 force: bool = False) -> MetsFile:
        path = os.path.join(self.directory, local_filename)
        existing = next(self.mets.find_files(ID=ID), None)
        if existing and not force:
            raise FileExistsError('file with ID %s already exists' % ID)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if content is not None:
            with open(path, 'w', encoding='utf-8') as fh:
                fh.write(content)
        f = MetsFile(ID=ID, fileGrp=file_grp, mimetype=mimetype,
                     local_filename=local_filename, pageId=pageId)
        if existing:  # force: drop the old entry WHEREVER it lives
            self.mets.file_groups[existing.fileGrp].remove(existing)
        self.mets.file_groups.setdefault(file_grp, []).append(f)
        if pageId and pageId not in self.mets.page_ids:
            self.mets.page_ids.append(pageId)
        return f

    def save_mets(self):
        with open(self.mets_path, 'w', encoding='utf-8') as fh:
            fh.write(mets_to_xml(self.mets))


def parse_mets(source) -> Mets:
    root = etree.parse(source, parser=xml_parser()).getroot()
    mets = Mets()
    mets.root = root
    ident = root.find('.//%sidentifier' % _MODS)
    if ident is not None and ident.text:
        mets.unique_identifier = ident.text.strip()
    # file section
    file_to_page: Dict[str, str] = {}
    for div in root.findall(
            './/%sstructMap[@TYPE="PHYSICAL"]//%sdiv' % (_M, _M)):
        if div.get('TYPE') != 'page':
            continue
        page_id = div.get('ID') or div.get('ORDER') or ''
        if page_id:
            mets.page_ids.append(page_id)
        for fptr in div.findall('%sfptr' % _M):
            file_to_page[fptr.get('FILEID', '')] = page_id
    for grp_el in root.findall('.//%sfileGrp' % _M):
        grp = grp_el.get('USE', '')
        files = []
        for f_el in grp_el.findall('%sfile' % _M):
            fid = f_el.get('ID', '')
            flocat = f_el.find('%sFLocat' % _M)
            href = flocat.get('%shref' % _X) if flocat is not None else None
            files.append(MetsFile(
                ID=fid, fileGrp=grp,
                mimetype=f_el.get('MIMETYPE', MIMETYPE_PAGE),
                local_filename=href,
                pageId=file_to_page.get(fid)))
        mets.file_groups[grp] = files
    return mets


def _update_mets_tree(mets: Mets) -> None:
    """Apply the model's fileSec/structMap state to the ORIGINAL
    parsed document in place (adds, force-replaces, removals); every
    unmodeled METS section stays byte-for-byte."""
    root = mets.root
    file_sec = root.find(_M + 'fileSec')
    if file_sec is None:
        file_sec = etree.Element(_M + 'fileSec')
        # schema order: ... amdSec*, fileSec?, structMap+
        struct_maps = root.findall(_M + 'structMap')
        if struct_maps:
            root.insert(list(root).index(struct_maps[0]), file_sec)
        else:
            root.append(file_sec)
    grp_els = {g.get('USE', ''): g
               for g in file_sec.findall(_M + 'fileGrp')}
    file_els: Dict[str, tuple] = {}
    for g in file_sec.findall(_M + 'fileGrp'):
        for fe in g.findall(_M + 'file'):
            file_els[fe.get('ID', '')] = (g, fe)
    struct = None
    for sm in root.findall(_M + 'structMap'):
        if sm.get('TYPE') == 'PHYSICAL':
            struct = sm
            break
    if struct is None:
        struct = etree.SubElement(root, _M + 'structMap',
                                  TYPE='PHYSICAL')
    top = struct.find(_M + 'div')
    if top is None:
        top = etree.SubElement(struct, _M + 'div', TYPE='physSequence')
    page_divs = {d.get('ID') or d.get('ORDER') or '': d
                 for d in struct.iter(_M + 'div')
                 if d.get('TYPE') == 'page'}
    fptr_ids = {fp.get('FILEID', '') for fp in struct.iter(_M + 'fptr')}
    model_ids = set()
    for grp, files in mets.file_groups.items():
        ge = grp_els.get(grp)
        if ge is None:
            ge = etree.SubElement(file_sec, _M + 'fileGrp', USE=grp)
            grp_els[grp] = ge
        for f in files:
            model_ids.add(f.ID)
            cur = file_els.get(f.ID)
            if cur is not None:
                cur_g, fe = cur
                if cur_g is not ge:  # force-replace moved groups
                    cur_g.remove(fe)
                    ge.append(fe)
                    file_els[f.ID] = (ge, fe)
                fe.set('MIMETYPE', f.mimetype or '')
                fl = fe.find(_M + 'FLocat')
            else:
                fe = etree.SubElement(ge, _M + 'file', ID=f.ID,
                                      MIMETYPE=f.mimetype or '')
                fl = None
                file_els[f.ID] = (ge, fe)
            if fl is None:
                fl = etree.SubElement(fe, _M + 'FLocat',
                                      LOCTYPE='OTHER',
                                      OTHERLOCTYPE='FILE')
            fl.set(_X + 'href', f.local_filename or '')
            if f.pageId and f.ID not in fptr_ids:
                div = page_divs.get(f.pageId)
                if div is None:
                    div = etree.SubElement(top, _M + 'div',
                                           TYPE='page', ID=f.pageId)
                    page_divs[f.pageId] = div
                etree.SubElement(div, _M + 'fptr', FILEID=f.ID)
                fptr_ids.add(f.ID)
    # files force-dropped from the model lose their entries + fptrs
    for fid, (g, fe) in list(file_els.items()):
        if fid not in model_ids:
            g.remove(fe)
            for div in struct.iter(_M + 'div'):
                for fp in div.findall(_M + 'fptr'):
                    if fp.get('FILEID') == fid:
                        div.remove(fp)


def mets_to_xml(mets: Mets) -> str:
    if mets.root is not None:
        _update_mets_tree(mets)
        return etree.tostring(mets.root, encoding='UTF-8',
                              xml_declaration=True).decode('utf-8')
    root = etree.Element(_M + 'mets')
    if mets.unique_identifier:
        dmd = etree.SubElement(root, _M + 'dmdSec', ID='DMDLOG_0000')
        wrap = etree.SubElement(dmd, _M + 'mdWrap', MDTYPE='MODS')
        xml_data = etree.SubElement(wrap, _M + 'xmlData')
        mods = etree.SubElement(xml_data, _MODS + 'mods')
        ident = etree.SubElement(mods, _MODS + 'identifier', type='purl')
        ident.text = mets.unique_identifier
    file_sec = etree.SubElement(root, _M + 'fileSec')
    for grp, files in mets.file_groups.items():
        grp_el = etree.SubElement(file_sec, _M + 'fileGrp', USE=grp)
        for f in files:
            f_el = etree.SubElement(grp_el, _M + 'file', ID=f.ID,
                                    MIMETYPE=f.mimetype or '')
            flocat = etree.SubElement(f_el, _M + 'FLocat',
                                      LOCTYPE='OTHER',
                                      OTHERLOCTYPE='FILE')
            flocat.set(_X + 'href', f.local_filename or '')
    struct = etree.SubElement(root, _M + 'structMap', TYPE='PHYSICAL')
    top = etree.SubElement(struct, _M + 'div',
                           TYPE='physSequence')
    # one pass over all files (find_files per page is O(pages * files);
    # save_mets runs after every page write, so that was quadratic in
    # document size)
    by_page: dict = {}
    for files in mets.file_groups.values():
        for f in files:
            if f.pageId:
                by_page.setdefault(f.pageId, []).append(f)
    for page_id in mets.page_ids:
        div = etree.SubElement(top, _M + 'div', TYPE='page', ID=page_id)
        for f in by_page.get(page_id, ()):
            etree.SubElement(div, _M + 'fptr', FILEID=f.ID)
    return tostring(root)

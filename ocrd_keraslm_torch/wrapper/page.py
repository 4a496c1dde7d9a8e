"""Standalone PAGE-XML object model (parse / mutate / serialize).

The reference relies on the external ``ocrd_models.ocrd_page``
(generateDS) classes (reference wrapper/rate.py:12-28).
This environment has no ocrd distribution, so this module provides a
self-contained ElementTree-based implementation of the subset the framework
needs: the Page -> TextRegion -> TextLine -> Word -> Glyph hierarchy
with TextEquiv alternatives (Unicode/conf/index), ReadingOrder groups,
``textLineOrder`` / ``readingDirection`` attributes, ``Relation``
elements (type=join), pcGtsId, and Metadata processing-step agents.

The accessor names (``get_TextEquiv``, ``set_TextEquiv``,
``get_TextRegion``, ...) intentionally mirror the generateDS API so the
processor code reads the same against either backend.
"""
from __future__ import annotations

import datetime
from typing import List, Optional

import xml.etree.ElementTree as etree

PAGE_NS = 'http://schema.primaresearch.org/PAGE/gts/pagecontent/2019-07-15'
_P = '{%s}' % PAGE_NS
# serialize PAGE as the default namespace (ElementTree's prefix registry
# is process-wide; the PAGE and METS namespaces never collide)
etree.register_namespace('', PAGE_NS)

# reading-order / line-order attribute values (PAGE simpleTypes)
RIGHT_TO_LEFT = 'right-to-left'
BOTTOM_TO_TOP = 'bottom-to-top'


def _q(tag):
    return _P + tag


class TextEquivType:
    """One textual alternative with confidence."""

    def __init__(self, Unicode: str = '', conf=None, index=None,
                 dataType=None, dataTypeDetails=None):
        self.Unicode = Unicode
        self.conf = conf
        self.index = index
        self.dataType = dataType
        self.dataTypeDetails = dataTypeDetails

    def get_conf(self):
        return self.conf

    def set_conf(self, conf):
        self.conf = conf

    def get_index(self):
        return self.index

    def __repr__(self):
        return 'TextEquiv(%r, conf=%s)' % (self.Unicode, self.conf)


class _TextElement:
    """Shared base: id + TextEquiv list + layout attrs + coords."""

    tag = ''
    child_attr = None     # name of child list attribute
    child_tag = ''        # XML tag of children

    def __init__(self, id: str = ''):
        self.id = id
        self.text_equivs: List[TextEquivType] = []
        self.readingDirection: Optional[str] = None
        self.textLineOrder: Optional[str] = None
        self.custom: Optional[str] = None
        self.coords_points: Optional[str] = None

    # generateDS-style API
    def get_TextEquiv(self):
        return self.text_equivs

    def set_TextEquiv(self, tes):
        self.text_equivs = list(tes)

    def add_TextEquiv(self, te):
        self.text_equivs.append(te)

    def get_readingDirection(self):
        return self.readingDirection

    def get_textLineOrder(self):
        return self.textLineOrder


class Glyph(_TextElement):
    tag = 'Glyph'


class Word(_TextElement):
    tag = 'Word'

    def __init__(self, id=''):
        super().__init__(id)
        self.glyphs: List[Glyph] = []

    def get_Glyph(self):
        return self.glyphs

    def add_Glyph(self, g):
        self.glyphs.append(g)


class TextLine(_TextElement):
    tag = 'TextLine'

    def __init__(self, id=''):
        super().__init__(id)
        self.words: List[Word] = []

    def get_Word(self):
        return self.words

    def add_Word(self, w):
        self.words.append(w)


class TextRegion(_TextElement):
    tag = 'TextRegion'

    def __init__(self, id=''):
        super().__init__(id)
        self.lines: List[TextLine] = []
        self.text_regions: List['TextRegion'] = []
        self.type: Optional[str] = None

    def get_TextLine(self):
        return self.lines

    def add_TextLine(self, line):
        self.lines.append(line)

    def get_TextRegion(self):
        return self.text_regions


# ---------------------------------------------------------------------
# reading order
# ---------------------------------------------------------------------

class RegionRefType:
    def __init__(self, regionRef=''):
        self.regionRef = regionRef

    def get_regionRef(self):
        return self.regionRef


class RegionRefIndexedType(RegionRefType):
    def __init__(self, regionRef='', index=0):
        super().__init__(regionRef)
        self.index = index


class _Group:
    def __init__(self, id='', regionRef=''):
        self.id = id
        # nested groups reference the region they order (PAGE schema
        # regionRef attribute); reading-order lookups key on it
        self.regionRef = regionRef
        self.region_refs: List[RegionRefType] = []
        self.ordered_groups: List['OrderedGroupIndexedType'] = []
        self.unordered_groups: List['UnorderedGroupIndexedType'] = []

    def get_regionRef(self):
        return self.regionRef


class OrderedGroupType(_Group):
    def get_RegionRefIndexed(self):
        return self.region_refs

    def get_OrderedGroupIndexed(self):
        return self.ordered_groups

    def get_UnorderedGroupIndexed(self):
        return self.unordered_groups


class OrderedGroupIndexedType(OrderedGroupType):
    def __init__(self, id='', index=0):
        super().__init__(id)
        self.index = index


class UnorderedGroupType(_Group):
    def get_RegionRef(self):
        return self.region_refs

    def get_OrderedGroup(self):
        return self.ordered_groups

    def get_UnorderedGroup(self):
        return self.unordered_groups


class UnorderedGroupIndexedType(UnorderedGroupType):
    def __init__(self, id='', index=0):
        super().__init__(id)
        self.index = index


class ReadingOrder:
    def __init__(self):
        self.ordered_group: Optional[OrderedGroupType] = None
        self.unordered_group: Optional[UnorderedGroupType] = None

    def get_OrderedGroup(self):
        return self.ordered_group

    def get_UnorderedGroup(self):
        return self.unordered_group


class RelationType:
    def __init__(self, type='', source='', target=''):
        self.type = type
        self._source = RegionRefType(source)
        self._target = RegionRefType(target)

    def get_type(self):
        return self.type

    def get_SourceRegionRef(self):
        return self._source

    def get_TargetRegionRef(self):
        return self._target


class RelationsType:
    def __init__(self):
        self.relations: List[RelationType] = []

    def get_Relation(self):
        return self.relations


# ---------------------------------------------------------------------
# page / document
# ---------------------------------------------------------------------

class Page:
    def __init__(self):
        self.regions: List[TextRegion] = []
        self.reading_order: Optional[ReadingOrder] = None
        self.relations: Optional[RelationsType] = None
        self.readingDirection: Optional[str] = None
        self.textLineOrder: Optional[str] = None
        self.imageFilename: str = ''
        self.imageWidth = 0
        self.imageHeight = 0

    def get_TextRegion(self):
        return self.regions

    def add_TextRegion(self, region):
        self.regions.append(region)

    def get_AllRegions(self, classes=None, order='document'):
        """All (text) regions, depth-first."""
        out = []

        def walk(region):
            out.append(region)
            for sub in region.text_regions:
                walk(sub)
        for r in self.regions:
            walk(r)
        return out

    def get_ReadingOrder(self):
        return self.reading_order

    def get_Relations(self):
        return self.relations

    def get_readingDirection(self):
        return self.readingDirection

    def get_textLineOrder(self):
        return self.textLineOrder


class MetadataItem:
    def __init__(self, type='processingStep', name='', value='',
                 labels=None):
        self.type = type
        self.name = name
        self.value = value
        self.labels = labels or {}  # {group: {key: value}}
        # parsed Labels groups with their ORIGINAL attribute
        # (externalModel vs comments, possibly neither): emission
        # round-trips from here when present, so existing metadata is
        # never rewritten under a different attribute.  labels stays
        # the construction-side API ({comments-group: {k: v}}).
        self.label_groups = None  # [(externalModel, comments, {k: v})]


class Metadata:
    def __init__(self):
        self.creator = ''
        self.created = ''
        self.last_change = ''
        self.items: List[MetadataItem] = []


class PcGts:
    def __init__(self):
        self.pcGtsId: Optional[str] = None
        self.page = Page()
        self.metadata = Metadata()

    def get_Page(self):
        return self.page

    def get_pcGtsId(self):
        return self.pcGtsId

    def set_pcGtsId(self, value):
        self.pcGtsId = value

    def get_Metadata(self):
        return self.metadata

    def add_metadata_item(self, item: MetadataItem):
        self.metadata.items.append(item)


# ---------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------

# qualified tags precomputed: _q() string formatting inside the
# per-element parse loops cost ~25k calls per 8-page workspace
_Q_TEXTEQUIV = _P + 'TextEquiv'
_Q_UNICODE = _P + 'Unicode'
_Q_COORDS = _P + 'Coords'


def _parse_textequivs(el) -> List[TextEquivType]:
    tes = []
    for te in el:
        if te.tag != _Q_TEXTEQUIV:
            continue
        uni = ''
        for sub in te:
            if sub.tag == _Q_UNICODE:
                uni = sub.text or ''
                break
        get = te.get
        conf = get('conf')
        index = get('index')
        tes.append(TextEquivType(
            Unicode=uni,
            conf=float(conf) if conf is not None else None,
            index=int(index) if index is not None else None,
            dataType=get('dataType'),
            dataTypeDetails=get('dataTypeDetails')))
    # sort by index where present (PAGE semantics: index = rank)
    if len(tes) > 1 and all(te.index is not None for te in tes):
        tes.sort(key=lambda te: te.index)
    return tes


def _parse_common(obj: _TextElement, el):
    get = el.get
    obj.id = get('id', '')
    obj.readingDirection = get('readingDirection')
    obj.textLineOrder = get('textLineOrder')
    obj.custom = get('custom')
    coords = el.find(_Q_COORDS)
    if coords is not None:
        obj.coords_points = coords.get('points')
    obj.text_equivs = _parse_textequivs(el)


def _parse_region(el) -> TextRegion:
    region = TextRegion()
    _parse_common(region, el)
    region.type = el.get('type')
    for line_el in el.findall(_q('TextLine')):
        line = TextLine()
        _parse_common(line, line_el)
        for word_el in line_el.findall(_q('Word')):
            word = Word()
            _parse_common(word, word_el)
            for glyph_el in word_el.findall(_q('Glyph')):
                glyph = Glyph()
                _parse_common(glyph, glyph_el)
                word.glyphs.append(glyph)
            line.words.append(word)
        region.lines.append(line)
    for sub_el in el.findall(_q('TextRegion')):
        region.text_regions.append(_parse_region(sub_el))
    return region


def _parse_group(el, indexed):
    if el.tag == _q('OrderedGroup') or el.tag == _q('OrderedGroupIndexed'):
        group = (OrderedGroupIndexedType(el.get('id', ''),
                                         int(el.get('index', 0)))
                 if indexed else OrderedGroupType(el.get('id', '')))
        group.regionRef = el.get('regionRef', '')
        for sub in el:
            if sub.tag == _q('RegionRefIndexed'):
                group.region_refs.append(RegionRefIndexedType(
                    sub.get('regionRef', ''), int(sub.get('index', 0))))
            elif sub.tag == _q('OrderedGroupIndexed'):
                group.ordered_groups.append(_parse_group(sub, True))
            elif sub.tag == _q('UnorderedGroupIndexed'):
                group.unordered_groups.append(_parse_group(sub, True))
        return group
    group = (UnorderedGroupIndexedType(el.get('id', ''),
                                       int(el.get('index', 0)))
             if indexed else UnorderedGroupType(el.get('id', '')))
    group.regionRef = el.get('regionRef', '')
    for sub in el:
        if sub.tag == _q('RegionRef'):
            group.region_refs.append(
                RegionRefType(sub.get('regionRef', '')))
        elif sub.tag == _q('OrderedGroup'):
            group.ordered_groups.append(_parse_group(sub, False))
        elif sub.tag == _q('UnorderedGroup'):
            group.unordered_groups.append(_parse_group(sub, False))
    return group


def xml_parser():
    """An ElementTree parser that keeps comments and processing
    instructions, so a parsed tree serializes back with them."""
    return etree.XMLParser(target=etree.TreeBuilder(insert_comments=True,
                                                    insert_pis=True))


def _indent(elem, level=0):
    """Indent as libxml2's formatted output (lxml's ``pretty_print``)
    does: an element whose children include a text node (its text or a
    child's tail, whitespace too) keeps all it holds as it is; the
    children of any other element go on lines of their own, two spaces
    a level."""
    children = list(elem)
    if not children or elem.text or any(c.tail for c in children):
        return
    pad = '\n' + '  ' * (level + 1)
    elem.text = pad
    for child in children:
        child.tail = pad
        _indent(child, level + 1)
    children[-1].tail = pad[:-2]


def tostring(root) -> str:
    """UTF-8 serialization with an XML declaration, in the bytes lxml's
    ``pretty_print`` writes (the JAX package's writer): new elements
    indented where their parent holds no text (:func:`_indent`), an
    empty element as ``<a/>``, a newline at the end.  ElementTree writes
    ``<a />``; it escapes every ``>`` in text and attribute values, so
    ``' />'`` closes a tag (a comment that holds it loses the space
    too)."""
    _indent(root)
    return etree.tostring(root, encoding='UTF-8', xml_declaration=True) \
        .decode('utf-8').replace(' />', '/>') + '\n'


def parse_page_root(source):
    """Parse PAGE-XML from a path / bytes / file-like to the etree root,
    re-namespaced to the pagecontent version this module emits.

    Namespace handling: accept any PAGE pagecontent version by
    re-namespacing; REJECT anything else loudly (silently returning an
    empty PcGts would make the processor overwrite the page with empty
    output).  Shared by the object-model parse and the etree-direct
    fast path (page_fast)."""
    if isinstance(source, bytes):
        root = etree.fromstring(source, parser=xml_parser())
    elif isinstance(source, str) and source.lstrip().startswith('<'):
        root = etree.fromstring(source.encode('utf-8'), parser=xml_parser())
    else:
        root = etree.parse(source, parser=xml_parser()).getroot()
    tag = root.tag if isinstance(root.tag, str) else ''
    if tag.startswith('{'):
        ns = tag[1:].split('}', 1)[0]
        # the root must be PcGts in SOME pagecontent namespace — a
        # bare {ns}Page fragment (or any other element) must reject,
        # not yield an empty document
        if 'PAGE/gts/pagecontent' not in ns or \
                not tag.endswith('}PcGts'):
            raise ValueError('not a PAGE-XML document (root %s)'
                             % tag)
        if ns != PAGE_NS:
            old = '{%s}' % ns
            for el in root.iter():
                if isinstance(el.tag, str) and el.tag.startswith(old):
                    el.tag = _P + el.tag[len(old):]
    elif tag == 'PcGts':
        # legacy no-namespace document: qualify the whole tree so the
        # lookups below actually find its children (accept-and-ignore
        # would silently overwrite the page with empty output)
        for el in root.iter():
            if isinstance(el.tag, str) and not el.tag.startswith('{'):
                el.tag = _P + el.tag
    else:
        raise ValueError('not a PAGE-XML document (root %r)' % tag)
    return root


def parse_reading_order(page_el) -> Optional[ReadingOrder]:
    """ReadingOrder object-model of an etree Page element (shared with
    the fast path: group records are consumed via isinstance in
    rate.page_get_reading_order, so both paths use THESE classes)."""
    ro_el = page_el.find(_q('ReadingOrder'))
    if ro_el is None:
        return None
    ro = ReadingOrder()
    og = ro_el.find(_q('OrderedGroup'))
    if og is not None:
        ro.ordered_group = _parse_group(og, False)
    ug = ro_el.find(_q('UnorderedGroup'))
    if ug is not None:
        ro.unordered_group = _parse_group(ug, False)
    return ro


def parse_relations(page_el) -> Optional[RelationsType]:
    """Relations object-model of an etree Page element (shared with the
    fast path)."""
    rel_el = page_el.find(_q('Relations'))
    if rel_el is None:
        return None
    rels = RelationsType()
    for r in rel_el.findall(_q('Relation')):
        refs = r.findall(_q('RegionRef'))
        src = r.find(_q('SourceRegionRef'))
        tgt = r.find(_q('TargetRegionRef'))
        rel = RelationType(r.get('type', ''))
        if src is not None:
            rel._source = RegionRefType(src.get('regionRef', ''))
        elif len(refs) > 0:
            rel._source = RegionRefType(refs[0].get('regionRef', ''))
        if tgt is not None:
            rel._target = RegionRefType(tgt.get('regionRef', ''))
        elif len(refs) > 1:
            rel._target = RegionRefType(refs[1].get('regionRef', ''))
        rels.relations.append(rel)
    return rels


def parse_page(source) -> PcGts:
    """Parse PAGE-XML from a path / bytes / file-like into a PcGts."""
    root = parse_page_root(source)
    pcgts = PcGts()
    pcgts.pcGtsId = root.get('pcGtsId')
    meta_el = root.find(_q('Metadata'))
    if meta_el is not None:
        pcgts.metadata.creator = meta_el.findtext(_q('Creator')) or ''
        pcgts.metadata.created = meta_el.findtext(_q('Created')) or ''
        pcgts.metadata.last_change = (
            meta_el.findtext(_q('LastChange')) or '')
        for item_el in meta_el.findall(_q('MetadataItem')):
            item = MetadataItem(type=item_el.get('type', ''),
                                name=item_el.get('name', ''),
                                value=item_el.get('value', ''))
            item.label_groups = []
            for labels_el in item_el.findall(_q('Labels')):
                ext = labels_el.get('externalModel', '')
                com = labels_el.get('comments', '')
                labels = {l.get('type', ''): l.get('value', '')
                          for l in labels_el.findall(_q('Label'))}
                item.label_groups.append((ext, com, labels))
                item.labels[ext or com] = labels
            pcgts.metadata.items.append(item)
    page_el = root.find(_q('Page'))
    if page_el is not None:
        page = pcgts.page
        page.imageFilename = page_el.get('imageFilename', '')
        page.imageWidth = int(page_el.get('imageWidth', 0) or 0)
        page.imageHeight = int(page_el.get('imageHeight', 0) or 0)
        page.readingDirection = page_el.get('readingDirection')
        page.textLineOrder = page_el.get('textLineOrder')
        for region_el in page_el.findall(_q('TextRegion')):
            page.regions.append(_parse_region(region_el))
        page.reading_order = parse_reading_order(page_el)
        page.relations = parse_relations(page_el)
    return pcgts


# ---------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------

def _emit_textequivs(el, obj):
    for te in obj.text_equivs:
        te_el = etree.SubElement(el, _q('TextEquiv'))
        if te.index is not None:
            te_el.set('index', str(te.index))
        if te.conf is not None:
            te_el.set('conf', '%.6g' % float(te.conf))
        if te.dataType:
            te_el.set('dataType', te.dataType)
        if te.dataTypeDetails:
            te_el.set('dataTypeDetails', te.dataTypeDetails)
        uni = etree.SubElement(te_el, _q('Unicode'))
        uni.text = te.Unicode


def _emit_common(el, obj):
    if obj.id:
        el.set('id', obj.id)
    if obj.readingDirection:
        el.set('readingDirection', obj.readingDirection)
    if obj.textLineOrder:
        el.set('textLineOrder', obj.textLineOrder)
    if obj.custom:
        el.set('custom', obj.custom)
    if obj.coords_points:
        coords = etree.SubElement(el, _q('Coords'))
        coords.set('points', obj.coords_points)


def _emit_region(parent, region):
    el = etree.SubElement(parent, _q('TextRegion'))
    _emit_common(el, region)
    if region.type:
        el.set('type', region.type)
    # PAGE XSD: TextRegionType EXTENDS RegionType, so the base's
    # nested-region particle precedes the extension's TextLine*,
    # TextEquiv*, TextStyle? — emit subregions FIRST
    for sub in region.text_regions:
        _emit_region(el, sub)
    for line in region.lines:
        line_el = etree.SubElement(el, _q('TextLine'))
        _emit_common(line_el, line)
        for word in line.words:
            word_el = etree.SubElement(line_el, _q('Word'))
            _emit_common(word_el, word)
            for glyph in word.glyphs:
                glyph_el = etree.SubElement(word_el, _q('Glyph'))
                _emit_common(glyph_el, glyph)
                _emit_textequivs(glyph_el, glyph)
            _emit_textequivs(word_el, word)
        _emit_textequivs(line_el, line)
    _emit_textequivs(el, region)


def _emit_group(parent, group, tag):
    el = etree.SubElement(parent, _q(tag))
    if group.id:
        el.set('id', group.id)
    if hasattr(group, 'index'):
        el.set('index', str(group.index))
    if getattr(group, 'regionRef', ''):
        el.set('regionRef', group.regionRef)
    for ref in group.region_refs:
        if isinstance(ref, RegionRefIndexedType):
            ref_el = etree.SubElement(el, _q('RegionRefIndexed'))
            ref_el.set('index', str(ref.index))
        else:
            ref_el = etree.SubElement(el, _q('RegionRef'))
        ref_el.set('regionRef', ref.regionRef)
    for sub in group.ordered_groups:
        _emit_group(el, sub, 'OrderedGroupIndexed'
                    if hasattr(sub, 'index') else 'OrderedGroup')
    for sub in group.unordered_groups:
        _emit_group(el, sub, 'UnorderedGroupIndexed'
                    if hasattr(sub, 'index') else 'UnorderedGroup')


def emit_metadata_item(meta_el, item: MetadataItem):
    """Append one MetadataItem (processing-step agent) to an etree
    Metadata element (shared with the fast path)."""
    item_el = etree.SubElement(meta_el, _q('MetadataItem'))
    item_el.set('type', item.type)
    if item.name:
        item_el.set('name', item.name)
    if item.value:
        item_el.set('value', item.value)
    if item.label_groups is not None:  # parsed: exact round-trip
        groups = item.label_groups
    else:  # constructed: comments-keyed dict (the processor's agents)
        groups = [('', g, labels) for g, labels in item.labels.items()]
    for ext, com, labels in groups:
        labels_el = etree.SubElement(item_el, _q('Labels'))
        if ext:
            labels_el.set('externalModel', ext)
        if com:
            labels_el.set('comments', com)
        for k, v in labels.items():
            label_el = etree.SubElement(labels_el, _q('Label'))
            label_el.set('type', k)
            label_el.set('value', str(v))


def to_xml(pcgts) -> str:
    """Serialize a PcGts (or a page_fast document, which serializes
    its retained tree in place) back to a PAGE-XML string."""
    fast = getattr(pcgts, 'fast_tostring', None)
    if fast is not None:
        return fast()
    root = etree.Element(_q('PcGts'))
    if pcgts.pcGtsId:
        root.set('pcGtsId', pcgts.pcGtsId)
    meta = etree.SubElement(root, _q('Metadata'))
    creator = etree.SubElement(meta, _q('Creator'))
    creator.text = pcgts.metadata.creator or 'ocrd_keraslm_torch'
    created = etree.SubElement(meta, _q('Created'))
    created.text = (pcgts.metadata.created or
                    datetime.datetime.now().isoformat())
    change = etree.SubElement(meta, _q('LastChange'))
    change.text = datetime.datetime.now().isoformat()
    for item in pcgts.metadata.items:
        emit_metadata_item(meta, item)
    page = pcgts.page
    page_el = etree.SubElement(root, _q('Page'))
    page_el.set('imageFilename', page.imageFilename or '')
    page_el.set('imageWidth', str(page.imageWidth))
    page_el.set('imageHeight', str(page.imageHeight))
    if page.readingDirection:
        page_el.set('readingDirection', page.readingDirection)
    if page.textLineOrder:
        page_el.set('textLineOrder', page.textLineOrder)
    if page.reading_order is not None:
        ro_el = etree.SubElement(page_el, _q('ReadingOrder'))
        if page.reading_order.ordered_group is not None:
            _emit_group(ro_el, page.reading_order.ordered_group,
                        'OrderedGroup')
        if page.reading_order.unordered_group is not None:
            _emit_group(ro_el, page.reading_order.unordered_group,
                        'UnorderedGroup')
    if page.relations is not None:
        rel_el = etree.SubElement(page_el, _q('Relations'))
        for rel in page.relations.relations:
            r_el = etree.SubElement(rel_el, _q('Relation'))
            r_el.set('type', rel.type)
            s_el = etree.SubElement(r_el, _q('SourceRegionRef'))
            s_el.set('regionRef', rel._source.regionRef)
            t_el = etree.SubElement(r_el, _q('TargetRegionRef'))
            t_el.set('regionRef', rel._target.regionRef)
    for region in page.regions:
        _emit_region(page_el, region)
    return tostring(root)

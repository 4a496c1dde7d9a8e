"""A small HDF5 reader and writer for Keras-2.3-layout checkpoints.

The port reads and writes its h5 models without h5py.  The reader
(:class:`File`) covers the subset of the HDF5 file format (version 0/1
superblocks) that h5py and Keras 2.3 write for
``save_weights``/``model.save`` files:

* groups: symbol tables (v1 B-tree + local heap) and compact link
  messages;
* object headers version 1 with continuation blocks;
* datasets with contiguous or compact layout and no filters;
* datatypes: integers, floats, fixed-length and variable-length strings
  (global heap), enums (h5py's bool);
* attributes (message versions 1-3) of those types.

Anything else (v2 object headers, chunked or compressed datasets, dense
link storage) raises ``ValueError`` naming the unsupported feature.

The writer (:func:`write_file`) writes a tree of groups, datasets and
attributes in the oldest layout, which every HDF5 library reads: a
version-0 superblock, version-1 object headers, symbol-table groups
(B-tree, local heap, symbol nodes with the entries sorted by name),
contiguous datasets, and the datatypes integer, float, fixed-length
string and h5py's bool enum.  Strings are fixed-length, so no global
heap is needed.  :func:`read_tree` reads a file back into the tree
that :func:`write_file` takes.
Reference: the HDF5 File Format Specification, version 3.0.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

SIGNATURE = b'\x89HDF\r\n\x1a\n'
UNDEFINED = 0xFFFFFFFFFFFFFFFF

MSG_DATASPACE = 0x0001
MSG_DATATYPE = 0x0003
MSG_LINK = 0x0006
MSG_LAYOUT = 0x0008
MSG_FILTERS = 0x000B
MSG_ATTRIBUTE = 0x000C
MSG_CONTINUATION = 0x0010
MSG_SYMBOL_TABLE = 0x0011


class _Type:
    """A parsed datatype: numpy dtype for fixed-size numbers, or a
    string kind ('vlen_str', 'fixed_str') with its element size."""

    def __init__(self, kind, size, dtype=None):
        self.kind, self.size, self.dtype = kind, size, dtype


class File:
    """An HDF5 file opened for reading (``with File(path) as f``)."""

    def __init__(self, path: str):
        with open(path, 'rb') as fh:
            self._buf = fh.read()
        base = 0
        while self._buf[base:base + 8] != SIGNATURE:
            base = 512 if base == 0 else base * 2
            if base >= len(self._buf):
                raise OSError('%s: no HDF5 signature' % path)
        sb = self._buf
        version = sb[base + 8]
        if version not in (0, 1):
            raise ValueError('%s: HDF5 superblock version %d is not '
                             'supported (0 and 1 are)' % (path, version))
        if sb[base + 13] != 8 or sb[base + 14] != 8:
            raise ValueError('%s: only 8-byte offsets and lengths are '
                             'supported' % path)
        pos = base + 24 + (4 if version == 1 else 0)
        self._base = struct.unpack_from('<Q', sb, pos)[0]
        root_entry = pos + 32
        root_header = struct.unpack_from('<Q', sb, root_entry + 8)[0]
        self._root = Group(self, root_header, '/')

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._buf = b''

    # the root group's interface
    def keys(self):
        return self._root.keys()

    def __contains__(self, name):
        return name in self._root

    def __getitem__(self, name):
        return self._root[name]

    def get(self, name, default=None):
        return self._root.get(name, default)

    @property
    def attrs(self):
        return self._root.attrs

    # -- low level ------------------------------------------------------

    def _u(self, fmt, pos):
        return struct.unpack_from('<' + fmt, self._buf, pos)

    def _addr(self, addr):
        return self._base + addr

    def _messages(self, header_addr):
        """[(type, data bytes)] of an object header (version 1)."""
        pos = self._addr(header_addr)
        version, _, n_msgs, _, size = self._u('BBHII', pos)
        if version != 1:
            raise ValueError('object header version %d at %#x is not '
                             'supported (1 is)' % (version, header_addr))
        blocks = [(pos + 16, size)]
        out = []
        while blocks and len(out) < n_msgs:
            start, length = blocks.pop(0)
            p = start
            while p + 8 <= start + length and len(out) < n_msgs:
                mtype, msize, _flags = self._u('HHB', p)
                data = self._buf[p + 8:p + 8 + msize]
                if mtype == MSG_CONTINUATION:
                    off, ln = struct.unpack_from('<QQ', data, 0)
                    blocks.append((self._addr(off), ln))
                out.append((mtype, data))
                p += 8 + msize
        return out

    def _local_heap(self, addr):
        pos = self._addr(addr)
        if self._buf[pos:pos + 4] != b'HEAP':
            raise ValueError('bad local heap at %#x' % addr)
        data_addr = self._u('Q', pos + 24)[0]
        return self._addr(data_addr)

    def _cstring(self, pos):
        end = self._buf.index(b'\0', pos)
        return self._buf[pos:end].decode('utf-8')

    def _symbol_table(self, btree_addr, heap_addr) -> Dict[str, int]:
        """{name: object header address} of an old-style group."""
        heap = self._local_heap(heap_addr)
        out: Dict[str, int] = {}
        todo = [btree_addr]
        while todo:
            pos = self._addr(todo.pop())
            sig = self._buf[pos:pos + 4]
            if sig == b'TREE':
                _type, level, used = self._u('BBH', pos + 4)
                p = pos + 24 + 8  # header, then key 0
                for _ in range(used):
                    todo.append(self._u('Q', p)[0])
                    p += 16       # child, next key
            elif sig == b'SNOD':
                n = self._u('H', pos + 6)[0]
                for i in range(n):
                    e = pos + 8 + 40 * i
                    name_off, header = self._u('QQ', e)
                    out[self._cstring(heap + name_off)] = header
            else:
                raise ValueError('bad group B-tree node at %#x' % pos)
        return out

    def _global_heap_object(self, coll_addr, index) -> bytes:
        pos = self._addr(coll_addr)
        if self._buf[pos:pos + 4] != b'GCOL':
            raise ValueError('bad global heap at %#x' % coll_addr)
        end = pos + self._u('Q', pos + 8)[0]
        p = pos + 16
        while p + 16 <= end:
            idx, _refs, _res, size = self._u('HHIQ', p)
            if idx == index:
                return self._buf[p + 16:p + 16 + size]
            if idx == 0:
                break
            p += 16 + ((size + 7) & ~7)
        raise ValueError('global heap object %d not found' % index)

    # -- message parsers ------------------------------------------------

    def _datatype(self, data, pos=0) -> _Type:
        cls_ver, b0, b1, b2, size = struct.unpack_from('<BBBBI', data, pos)
        cls = cls_ver & 0x0F
        bits = b0 | (b1 << 8) | (b2 << 16)
        order = '>' if bits & 1 else '<'
        if cls == 0:   # fixed-point
            signed = bool(bits & 0x08)
            return _Type('num', size, np.dtype(
                '%s%s%d' % (order, 'i' if signed else 'u', size)))
        if cls == 1:   # floating point
            return _Type('num', size, np.dtype('%sf%d' % (order, size)))
        if cls == 3:   # fixed-length string
            return _Type('fixed_str', size)
        if cls == 8:   # enumeration: its base integer type; h5py's bool
            base = self._datatype(data, pos + 8)
            names = data[pos + 8 + 12:pos + 8 + 12 + 16]
            if (bits & 0xFFFF) == 2 and base.size == 1 and \
                    names[:6] == b'FALSE\0' and names[8:13] == b'TRUE\0':
                return _Type('num', 1, np.dtype(bool))
            return base
        if cls == 9 and (bits & 0x0F) == 1:  # variable-length string
            return _Type('vlen_str', size)
        raise ValueError('HDF5 datatype class %d is not supported' % cls)

    @staticmethod
    def _dataspace(data) -> Optional[tuple]:
        """Shape of a dataspace message (() for scalar, None for null)."""
        version, ndims, flags = struct.unpack_from('<BBB', data, 0)
        if version == 1:
            pos = 8
        elif version == 2:
            if data[3] == 2:
                return None
            pos = 4
        else:
            raise ValueError('dataspace version %d' % version)
        return tuple(struct.unpack_from('<%dQ' % ndims, data, pos))

    def _values(self, dtype: _Type, shape, raw: bytes):
        """Decode ``raw`` element bytes into numpy (or a scalar)."""
        n = int(np.prod(shape)) if shape else 1
        if dtype.kind == 'num':
            arr = np.frombuffer(raw, dtype.dtype, n).astype(
                dtype.dtype.newbyteorder('='))
        elif dtype.kind == 'fixed_str':
            arr = np.array([raw[i * dtype.size:(i + 1) * dtype.size]
                            .rstrip(b'\0') for i in range(n)], object)
        else:
            items = []
            for i in range(n):
                length, coll, index = struct.unpack_from('<IQI', raw,
                                                         16 * i)
                items.append(self._global_heap_object(coll, index)[:length]
                             if length else b'')
            arr = np.array(items, object)
        return arr[0] if shape == () else arr.reshape(shape)


class _Object:
    def __init__(self, f: File, header: int, name: str):
        self._f, self._header, self.name = f, header, name
        self._msgs = f._messages(header)

    @property
    def attrs(self) -> Dict[str, object]:
        out = {}
        for mtype, data in self._msgs:
            if mtype != MSG_ATTRIBUTE:
                continue
            version = data[0]
            name_sz, type_sz, space_sz = struct.unpack_from('<HHH', data, 2)

            def pad(n):
                return (n + 7) & ~7 if version == 1 else n
            pos = 8 if version in (1, 2) else 9
            name = data[pos:pos + name_sz].rstrip(b'\0').decode('utf-8')
            pos += pad(name_sz)
            dtype = self._f._datatype(data, pos)
            pos += pad(type_sz)
            shape = self._f._dataspace(data[pos:pos + space_sz])
            pos += pad(space_sz)
            if shape is None:
                out[name] = None
                continue
            n = int(np.prod(shape)) if shape else 1
            out[name] = self._f._values(dtype, shape,
                                        data[pos:pos + n * dtype.size])
        return out


class Group(_Object):
    """An HDF5 group: a mapping of names to groups and datasets."""

    def __init__(self, f, header, name):
        super().__init__(f, header, name)
        self._links: Dict[str, int] = {}
        for mtype, data in self._msgs:
            if mtype == MSG_SYMBOL_TABLE:
                self._links.update(f._symbol_table(*struct.unpack_from(
                    '<QQ', data, 0)))
            elif mtype == MSG_LINK:
                self._links.update([self._parse_link(data)])

    @staticmethod
    def _parse_link(data):
        flags = data[1]
        pos = 2
        if flags & 0x08:
            if data[pos] != 0:
                raise ValueError('only hard links are supported')
            pos += 1
        if flags & 0x04:
            pos += 8
        if flags & 0x10:
            pos += 1
        width = 1 << (flags & 3)
        n = int.from_bytes(data[pos:pos + width], 'little')
        pos += width
        name = data[pos:pos + n].decode('utf-8')
        return name, struct.unpack_from('<Q', data, pos + n)[0]

    def keys(self) -> List[str]:
        return list(self._links)

    def __contains__(self, name):
        head, _, rest = name.partition('/')
        if head not in self._links:
            return False
        return not rest or rest in self[head]

    def __iter__(self):
        return iter(self._links)

    def get(self, name, default=None):
        return self[name] if name in self else default

    def __getitem__(self, name):
        head, _, rest = name.partition('/')
        header = self._links[head]
        types = {t for t, _ in self._f._messages(header)}
        obj = (Dataset if MSG_LAYOUT in types else Group)(
            self._f, header, self.name.rstrip('/') + '/' + head)
        return obj[rest] if rest else obj


class Dataset(_Object):
    """An HDF5 dataset; ``ds[()]`` or ``np.asarray(ds)`` reads it."""

    def __init__(self, f, header, name):
        super().__init__(f, header, name)
        msgs = dict(self._msgs)
        if MSG_FILTERS in msgs:
            raise ValueError('%s: filtered (compressed) datasets are not '
                             'supported' % name)
        self.dtype_info = f._datatype(msgs[MSG_DATATYPE])
        self.shape = f._dataspace(msgs[MSG_DATASPACE])
        self._layout = msgs[MSG_LAYOUT]

    def _raw(self) -> bytes:
        data = self._layout
        if data[0] != 3:
            raise ValueError('%s: data layout version %d is not supported '
                             '(3 is)' % (self.name, data[0]))
        n = int(np.prod(self.shape)) if self.shape else 1
        nbytes = n * self.dtype_info.size
        if data[1] == 0:    # compact
            size = struct.unpack_from('<H', data, 2)[0]
            return data[4:4 + size]
        if data[1] == 1:    # contiguous
            addr = struct.unpack_from('<Q', data, 2)[0]
            if addr == UNDEFINED:
                return b'\0' * nbytes
            pos = self._f._addr(addr)
            return self._f._buf[pos:pos + nbytes]
        raise ValueError('%s: chunked datasets are not supported'
                         % self.name)

    def __getitem__(self, key):
        if key != ():
            raise KeyError('only ds[()] reads are supported')
        return self._f._values(self.dtype_info, self.shape or (),
                               self._raw())

    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(self[()])
        return arr if dtype is None else arr.astype(dtype)


# ----------------------------------------------------------------------
# writer
# ----------------------------------------------------------------------

LEAF_K = 4        # a symbol node holds up to 2 * LEAF_K entries
INTERNAL_K = 16   # a group B-tree node holds up to 2 * INTERNAL_K children
MSG_FILL_VALUE = 0x0005


def _pad8(data: bytes) -> bytes:
    return data + b'\0' * (-len(data) % 8)


def _encode_value(value):
    """(datatype message, dataspace message, raw element bytes) of a
    dataset or attribute value: a numpy number array or scalar (bool as
    h5py's enum), ``bytes``/``str`` (a scalar fixed-length string), or a
    list or object array of those (a fixed-length string array)."""
    if isinstance(value, str):
        value = value.encode('utf-8')
    if isinstance(value, bytes):
        shape, items = (), [value]
    elif isinstance(value, (list, tuple)) or (
            isinstance(value, np.ndarray) and value.dtype.kind in 'OSU'):
        arr = np.asarray(value, dtype=object)
        shape = arr.shape
        items = [v.encode('utf-8') if isinstance(v, str) else bytes(v)
                 for v in arr.reshape(-1)]
    else:
        arr = np.asarray(value)
        shape, items = arr.shape, None
    if items is not None:
        size = max([len(v) for v in items] + [1])
        # class 3 (string), null-padded, ASCII
        dtype = struct.pack('<BBBBI', 0x13, 0x01, 0, 0, size)
        raw = b''.join(v.ljust(size, b'\0') for v in items)
    elif arr.dtype == bool:
        base = struct.pack('<BBBBIHH', 0x10, 0x08, 0, 0, 1, 0, 8)
        dtype = (struct.pack('<BBBBI', 0x18, 2, 0, 0, 1) + base
                 + b'FALSE\0\0\0TRUE\0\0\0\0' + b'\0\1')
        raw = arr.astype(np.uint8).tobytes()
    elif arr.dtype.kind in 'iu':
        n = arr.dtype.itemsize
        dtype = struct.pack('<BBBBIHH', 0x10,
                            0x08 if arr.dtype.kind == 'i' else 0, 0, 0, n,
                            0, 8 * n)
        raw = arr.astype(arr.dtype.newbyteorder('<')).tobytes()
    elif arr.dtype.kind == 'f' and arr.dtype.itemsize in (4, 8):
        n = arr.dtype.itemsize
        exp_bits, man_bits, bias = (8, 23, 127) if n == 4 else \
            (11, 52, 1023)
        dtype = struct.pack('<BBBBIHHBBBBI', 0x11, 0x20, 8 * n - 1, 0, n,
                            0, 8 * n, man_bits, exp_bits, 0, man_bits, bias)
        raw = arr.astype(arr.dtype.newbyteorder('<')).tobytes()
    else:
        raise ValueError('cannot write dtype %s to HDF5' % arr.dtype)
    space = struct.pack('<BBBB4x', 1, len(shape), 0, 0) + b''.join(
        struct.pack('<Q', d) for d in shape)
    return dtype, space, raw


class _Writer:
    """Lays a tree out in one buffer, children before parents (a header
    holds its children's addresses); every block starts at a multiple
    of 8."""

    def __init__(self):
        self.buf = bytearray(96)   # the superblock, filled in at the end

    def _alloc(self, data: bytes) -> int:
        addr = len(self.buf)
        self.buf += _pad8(data)
        return addr

    def _header(self, messages) -> int:
        """An object header (version 1) of ``[(type, data)]``."""
        body = b''.join(
            struct.pack('<HHB3x', mtype, len(_pad8(data)), 0) + _pad8(data)
            for mtype, data in messages)
        return self._alloc(struct.pack('<BBHII4x', 1, 0, len(messages), 1,
                                       len(body)) + body)

    @staticmethod
    def _attributes(attrs) -> list:
        out = []
        for name, value in attrs.items():
            dtype, space, raw = _encode_value(value)
            nm = name.encode('utf-8') + b'\0'
            out.append((MSG_ATTRIBUTE, struct.pack(
                '<BBHHH', 1, 0, len(nm), len(dtype), len(space))
                + _pad8(nm) + _pad8(dtype) + _pad8(space) + raw))
        return out

    def dataset(self, value, attrs) -> int:
        dtype, space, raw = _encode_value(value)
        addr = self._alloc(raw) if raw else UNDEFINED
        return self._header([
            (MSG_DATASPACE, space), (MSG_DATATYPE, dtype),
            # fill value: version 2, allocate late, never written,
            # undefined
            (MSG_FILL_VALUE, struct.pack('<BBBB', 2, 2, 2, 0)),
            (MSG_LAYOUT, struct.pack('<BBQQ', 3, 1, addr, len(raw))),
        ] + self._attributes(attrs))

    def group(self, items, attrs) -> tuple:
        """Write a group; returns (header, B-tree, heap) addresses."""
        entries = []
        for name in items:
            node = items[name]
            if isinstance(node, dict):
                header = self.group(node.get('items', {}),
                                    node.get('attrs', {}))[0]
            elif isinstance(node, Leaf):
                header = self.dataset(node.value, node.attrs)
            else:
                header = self.dataset(node, {})
            entries.append((name.encode('utf-8'), header))
        entries.sort()           # the library searches by strcmp order
        if len(entries) > 4 * LEAF_K * INTERNAL_K:
            raise ValueError('a group of %d entries needs a deeper B-tree '
                             'than this writer lays out' % len(entries))
        # local heap: the empty name at offset 0, the names, and one free
        # block at the end (the library wants a free list or none)
        heap = bytearray(8)
        offsets = []
        for name, _ in entries:
            offsets.append(len(heap))
            heap += _pad8(name + b'\0')
        free = len(heap)
        heap += struct.pack('<QQ', 1, 16)   # next: none (1); this block: 16
        heap_data = self._alloc(bytes(heap))
        heap_addr = self._alloc(b'HEAP' + struct.pack(
            '<B3xQQQ', 0, len(heap), free, heap_data))
        # symbol nodes of up to 2 * LEAF_K entries, in name order
        per = 2 * LEAF_K
        children, keys = [], [0]
        for lo in range(0, max(len(entries), 1), per):
            chunk = list(zip(offsets, entries))[lo:lo + per]
            body = b''.join(struct.pack('<QQII16x', off, header, 0, 0)
                            for off, (_, header) in chunk)
            children.append(self._alloc(
                b'SNOD' + struct.pack('<BBH', 1, 0, len(chunk))
                + body.ljust(per * 40, b'\0')))
            keys.append(chunk[-1][0] if chunk else 0)
        tree = b'TREE' + struct.pack('<BBHQQ', 0, 0, len(children),
                                     UNDEFINED, UNDEFINED)
        for key, child in zip(keys, children):
            tree += struct.pack('<QQ', key, child)
        tree += struct.pack('<Q', keys[-1])
        btree_addr = self._alloc(tree.ljust(
            24 + (4 * INTERNAL_K + 1) * 8, b'\0'))
        header = self._header(
            [(MSG_SYMBOL_TABLE, struct.pack('<QQ', btree_addr, heap_addr))]
            + self._attributes(attrs))
        return header, btree_addr, heap_addr

    def finish(self, root) -> bytes:
        header, btree_addr, heap_addr = root
        self.buf[:96] = (
            SIGNATURE + struct.pack('<BBBBBBBB', 0, 0, 0, 0, 0, 8, 8, 0)
            + struct.pack('<HHI', LEAF_K, INTERNAL_K, 0)
            + struct.pack('<QQQQ', 0, UNDEFINED, len(self.buf), UNDEFINED)
            # the root group's symbol table entry, B-tree and heap cached
            + struct.pack('<QQII', 0, header, 1, 0)
            + struct.pack('<QQ', btree_addr, heap_addr))
        return bytes(self.buf)


class Leaf:
    """A dataset ``value`` with attributes, as an item of a tree."""

    def __init__(self, value, attrs=None):
        self.value, self.attrs = value, dict(attrs or {})


def write_file(path: str, tree: dict) -> None:
    """Write ``tree`` as an HDF5 file.  A group is ``{'attrs': {name:
    value}, 'items': {name: group, value or Leaf}}``; a value is a numpy
    array or scalar, ``bytes``/``str``, or a list of those (see
    :func:`_encode_value`)."""
    writer = _Writer()
    data = writer.finish(writer.group(tree.get('items', {}),
                                      tree.get('attrs', {})))
    with open(path, 'wb') as fh:
        fh.write(data)


def read_tree(path: str) -> dict:
    """The whole of an HDF5 file as the tree :func:`write_file` takes
    (string values as ``bytes`` or object arrays of ``bytes``)."""
    def group(g):
        items = {}
        for name in g.keys():
            node = g[name]
            if isinstance(node, Group):
                items[name] = group(node)
            else:
                attrs = node.attrs
                items[name] = Leaf(node[()], attrs) if attrs else node[()]
        return {'attrs': g.attrs, 'items': items}
    with File(path) as f:
        return group(f._root)

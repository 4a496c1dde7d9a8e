"""A small HDF5 reader for Keras-2.3-layout checkpoints (no h5py).

Frozen copy of ``ocrd_keraslm_torch/utils/hdf5.py`` at commit 4cfb97a,
lines 30-385: the reader (``File``, ``Group``, ``Dataset``) as it was;
the module description is shortened and the writer (``write_file``,
``read_tree``, from line 387 on) left out.  The reference loads
``pretrained/model_german.h5`` with it, because the machine with the
card has no h5py and the reference may not import the port.  It covers
version 0/1 superblocks, symbol-table groups and compact links, version
1 object headers, contiguous or compact datasets without filters, and
integer, float, string and enum datatypes.
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

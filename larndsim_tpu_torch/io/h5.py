"""HDF5 files for the simulation's input and output, in numpy.

A small reader and writer of the part of HDF5 the simulation uses, so that
a run needs nothing beyond PyTorch and numpy (no h5py, no libhdf5): groups,
datasets of fixed-point, floating-point, boolean, fixed-length string and
compound (with array members) types, and attributes of the same types
(scalars, arrays and strings).

A :class:`File` holds the whole tree in memory.  Opened for writing, it is
written to disk once, when it is closed, with the file-format structures
of HDF5 1.8's default layout (superblock 0, version-1 object headers,
symbol-table groups, contiguous storage); h5py reads it as it reads its
own files.  The reader takes those structures, which is also the layout
h5py writes by default for such data.  Other layouts raise: chunked or
compressed datasets (as larnd-sim and edep-sim files written with
``maxshape`` or compression are) and newer superblocks.
"""
from __future__ import annotations

import os
import struct

import numpy as np

_SIGNATURE = b'\x89HDF\r\n\x1a\n'
_UNDEF = 0xFFFFFFFFFFFFFFFF
#: symbol-table node capacity 2*LEAF_K; B-tree node capacity 2*INTERNAL_K
_LEAF_K, _INTERNAL_K = 32, 16
_SNOD_SIZE = 8 + 2 * _LEAF_K * 40
_TREE_SIZE = 24 + 2 * _INTERNAL_K * 8 + (2 * _INTERNAL_K + 1) * 8

# object-header message types
_DATASPACE, _DATATYPE, _LAYOUT, _ATTRIBUTE = 0x01, 0x03, 0x08, 0x0C
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11


# --------------------------------------------------------------------------
# in-memory tree
# --------------------------------------------------------------------------

class Dataset:
    """A dataset held in memory as a numpy array."""

    def __init__(self, data: np.ndarray):
        self.data = self._buf = np.array(data)
        self.attrs: dict = {}

    shape = property(lambda self: self.data.shape)
    dtype = property(lambda self: self.data.dtype)

    def __len__(self):
        return len(self.data)

    def __array__(self, dtype=None, copy=None):
        return self.data if dtype is None else self.data.astype(dtype)

    def __getitem__(self, key):
        return self.data[key]

    def __setitem__(self, key, value):
        self.data[key] = value

    def resize(self, n: int, axis: int = 0) -> None:
        """Grow or shrink the first axis; new rows are zero.  ``data`` is a
        view of a buffer that at least doubles when it grows, so appending
        in many pieces copies each row a bounded number of times."""
        if axis != 0 or self.data.ndim == 0:
            raise NotImplementedError('resize along the first axis only')
        old, buf = len(self.data), self._buf
        if n > len(buf):
            buf = np.empty((max(n, 2 * len(buf)),) + buf.shape[1:],
                           buf.dtype)
            buf[:old] = self.data
        buf[old:n] = 0
        self._buf, self.data = buf, buf[:n]


class Group:
    """A group: named datasets and groups, plus attributes."""

    def __init__(self):
        self.members: dict = {}
        self.attrs: dict = {}

    def _walk(self, name: str, create: bool = False):
        parts = [p for p in name.split('/') if p]
        node = self
        for p in parts[:-1]:
            if p not in node.members:
                if not create:
                    raise KeyError(name)
                node.members[p] = Group()
            node = node.members[p]
        return node, parts[-1]

    def __contains__(self, name: str) -> bool:
        try:
            self[name]
        except KeyError:
            return False
        return True

    def __getitem__(self, name: str):
        parent, leaf = self._walk(name)
        return parent.members[leaf]

    def keys(self):
        return self.members.keys()

    def _add(self, name: str, obj):
        parent, leaf = self._walk(name, create=True)
        if leaf in parent.members:
            raise ValueError(f'{name} already exists')
        parent.members[leaf] = obj
        return obj

    def create_group(self, name: str) -> 'Group':
        return self._add(name, Group())

    def create_dataset(self, name: str, data, maxshape=None) -> Dataset:
        """``maxshape`` is accepted as h5py takes it: every dataset here
        can be resized."""
        return self._add(name, Dataset(data))


class File(Group):
    """An HDF5 file in memory: read at open ('r'), or written whole at
    close ('w')."""

    def __init__(self, path, mode: str = 'r'):
        super().__init__()
        if mode not in ('r', 'w'):
            raise ValueError(f'mode {mode!r}')
        self.path = os.fspath(path)
        self.mode = mode
        if mode == 'w':
            return
        with open(self.path, 'rb') as f:
            root = _Reader(f.read()).root()
        self.members, self.attrs = root.members, root.attrs

    def close(self) -> None:
        if self.mode == 'w':
            with open(self.path, 'wb') as f:
                f.writelines(_Writer().file_chunks(self))
            self.mode = 'r'

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()


# --------------------------------------------------------------------------
# datatypes
# --------------------------------------------------------------------------

def _pad8(b: bytes) -> bytes:
    return b + b'\0' * (-len(b) % 8)


def _dtype_header(cls: int, version: int, bits: int, size: int) -> bytes:
    return struct.pack('<BBHI', cls | (version << 4), bits & 0xFF,
                       bits >> 8, size)


def _encode_dtype(dt: np.dtype) -> bytes:
    """HDF5 datatype message for a numpy dtype (little-endian)."""
    if dt.byteorder == '>':
        raise NotImplementedError('big-endian data')
    if dt.kind == 'b':
        # h5py's boolean: an enum FALSE=0 / TRUE=1 over int8
        return (_dtype_header(8, 1, 2, 1) + _encode_dtype(np.dtype('i1'))
                + _pad8(b'FALSE\0') + _pad8(b'TRUE\0') + b'\x00\x01')
    if dt.kind in 'iu':
        bits = 0x08 if dt.kind == 'i' else 0
        return (_dtype_header(0, 1, bits, dt.itemsize)
                + struct.pack('<HH', 0, 8 * dt.itemsize))
    if dt.kind == 'f':
        exp, mant = {2: (5, 10), 4: (8, 23), 8: (11, 52)}[dt.itemsize]
        sign = 8 * dt.itemsize - 1
        # bits 4-5: implied leading mantissa bit; bits 8-15: sign position
        return (_dtype_header(1, 1, 0x20 | (sign << 8), dt.itemsize)
                + struct.pack('<HHBBBBI', 0, 8 * dt.itemsize, mant, exp, 0,
                              mant, (1 << (exp - 1)) - 1))
    if dt.kind == 'S':
        return _dtype_header(3, 1, 1, dt.itemsize)          # null-padded
    if dt.names is not None:
        body = b''
        for name in dt.names:
            field, offset = dt.fields[name][:2]
            base, dims = (field.base, field.shape) if field.shape \
                else (field, ())
            if len(dims) > 4:
                raise NotImplementedError('member arrays of rank > 4')
            body += (_pad8(name.encode() + b'\0')
                     + struct.pack('<IB3xI4x', offset, len(dims), 0)
                     + struct.pack('<4I', *dims, *[0] * (4 - len(dims)))
                     + _encode_dtype(base))
        return _dtype_header(6, 1, len(dt.names), dt.itemsize) + body
    raise NotImplementedError(f'dtype {dt}')


def _name(buf: bytes, p: int, padded: bool):
    """A null-terminated name at ``p`` and the position after it (names of
    older message versions are padded to a multiple of 8 bytes)."""
    end = buf.index(b'\0', p)
    return buf[p:end], (p + -(-(end + 1 - p) // 8) * 8 if padded
                        else end + 1)


def _decode_dtype(buf: bytes, pos: int):
    """(numpy dtype, position after the datatype message)."""
    cv, b0, b1, b2, size = struct.unpack_from('<BBBBI', buf, pos)
    cls, version = cv & 0x0F, cv >> 4
    bits = b0 | (b1 << 8) | (b2 << 16)
    p = pos + 8
    if bits & 1 and cls in (0, 1):
        raise NotImplementedError('big-endian data')
    if cls == 0:
        kind = 'i' if bits & 0x08 else 'u'
        return np.dtype(f'<{kind}{size}'), p + 4
    if cls == 1:
        return np.dtype(f'<f{size}'), p + 12
    if cls == 3:
        return np.dtype(f'S{size}'), p
    if cls == 6:
        names, formats, offsets = [], [], []
        for _ in range(bits & 0xFFFF):
            name, p = _name(buf, p, version < 3)
            names.append(name.decode())
            dims = ()
            if version < 3:
                offsets.append(struct.unpack_from('<I', buf, p)[0])
                p += 4
                if version == 1:
                    ndims = buf[p]
                    dims = struct.unpack_from('<4I', buf, p + 12)[:ndims]
                    p += 28
            else:
                nb = 1 if size < 1 << 8 else 2 if size < 1 << 16 else \
                    3 if size < 1 << 24 else 4
                offsets.append(int.from_bytes(buf[p:p + nb], 'little'))
                p += nb
            member, p = _decode_dtype(buf, p)
            formats.append((member, dims) if dims else member)
        return np.dtype({'names': names, 'formats': formats,
                         'offsets': offsets, 'itemsize': size}), p
    if cls == 8:
        base, p = _decode_dtype(buf, p)
        labels = []
        for _ in range(bits & 0xFFFF):
            name, p = _name(buf, p, version < 3)
            labels.append(name)
        p += len(labels) * base.itemsize
        if base == np.dtype('i1') and labels == [b'FALSE', b'TRUE']:
            return np.dtype('?'), p
        return base, p
    if cls == 10:
        ndims = buf[p]
        if version < 3:
            dims = struct.unpack_from(f'<{ndims}I', buf, p + 4)
            p += 4 + 8 * ndims
        else:
            dims = struct.unpack_from(f'<{ndims}I', buf, p + 1)
            p += 1 + 4 * ndims
        base, p = _decode_dtype(buf, p)
        return np.dtype((base, dims)), p
    raise NotImplementedError(f'HDF5 datatype class {cls}')


def _encode_dataspace(shape) -> bytes:
    # version 1; rank 0 is a scalar
    return (struct.pack('<BBBB4x', 1, len(shape), 0, 0)
            + b''.join(struct.pack('<Q', n) for n in shape))


def _decode_dataspace(buf: bytes, pos: int):
    """The shape, () for a scalar, None for a null dataspace."""
    version, rank = buf[pos], buf[pos + 1]
    if version == 1:
        p = pos + 8
    else:
        if buf[pos + 3] == 2:
            return None
        p = pos + 4
    return struct.unpack_from(f'<{rank}Q', buf, p)


def _as_array(value):
    """An attribute value as an array the writer can encode."""
    if isinstance(value, str):
        value = value.encode()
    if isinstance(value, bytes):
        return np.array(value, dtype=f'S{max(len(value), 1)}')
    return np.asarray(value)


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

class _Writer:
    """Serializes a :class:`Group` tree (children before their parents)
    into a list of byte chunks; dataset contents are not copied."""

    def __init__(self):
        self.chunks = [bytes(96)]                     # superblock, last
        self.size = 96

    def _alloc(self, data) -> int:
        pad = -self.size % 8
        if pad:
            self.chunks.append(bytes(pad))
        addr = self.size + pad
        self.chunks.append(data)
        self.size = addr + len(data)
        return addr

    @staticmethod
    def _header(messages) -> bytes:
        body = b''.join(struct.pack('<HHB3x', kind, len(_pad8(data)), 0)
                        + _pad8(data) for kind, data in messages)
        return struct.pack('<BBHII4x', 1, 0, len(messages), 1,
                           len(body)) + body

    @staticmethod
    def _attr_messages(attrs: dict):
        out = []
        for name, value in attrs.items():
            arr = _as_array(value)
            dt, ds = _encode_dtype(arr.dtype), _encode_dataspace(arr.shape)
            nm = name.encode() + b'\0'
            out.append((_ATTRIBUTE, struct.pack(
                '<BBHHH', 1, 0, len(nm), len(dt), len(ds))
                + _pad8(nm) + _pad8(dt) + _pad8(ds)
                + np.ascontiguousarray(arr).tobytes()))
        return out

    def _dataset(self, ds: Dataset) -> int:
        data = np.ascontiguousarray(ds.data)
        addr = (self._alloc(data.reshape(-1).view(np.uint8)) if data.nbytes
                else _UNDEF)
        return self._alloc(self._header(
            [(_DATASPACE, _encode_dataspace(data.shape)),
             (_DATATYPE, _encode_dtype(data.dtype)),
             (_LAYOUT, struct.pack('<BBQQ', 3, 1, addr, data.nbytes))]
            + self._attr_messages(ds.attrs)))

    def _group(self, g: Group) -> tuple[int, int, int]:
        names = sorted(g.members, key=lambda n: n.encode())
        if len(names) > 2 * _LEAF_K:
            raise NotImplementedError(f'more than {2 * _LEAF_K} members')
        children = [self._dataset(c) if isinstance(c, Dataset)
                    else self._group(c)[0]
                    for c in (g.members[n] for n in names)]
        heap, offsets = bytearray(8), []             # offset 0: ""
        for n in names:
            offsets.append(len(heap))
            heap += _pad8(n.encode() + b'\0')
        heap_data = self._alloc(bytes(heap))
        # free-list offset 1: the heap has no free block
        heap_addr = self._alloc(b'HEAP' + struct.pack(
            '<B3xQQQ', 0, len(heap), 1, heap_data))
        tree = struct.pack('<4sBBHQQ', b'TREE', 0, 0, 1 if names else 0,
                           _UNDEF, _UNDEF)
        if names:
            snod = struct.pack('<4sBxH', b'SNOD', 1, len(names))
            snod += b''.join(struct.pack('<QQI4x16x', off, addr, 0)
                             for off, addr in zip(offsets, children))
            snod_addr = self._alloc(snod.ljust(_SNOD_SIZE, b'\0'))
            tree += struct.pack('<QQQ', 0, snod_addr, offsets[-1])
        else:
            tree += struct.pack('<Q', 0)
        tree_addr = self._alloc(tree.ljust(_TREE_SIZE, b'\0'))
        header = self._alloc(self._header(
            [(_SYMBOL_TABLE, struct.pack('<QQ', tree_addr, heap_addr))]
            + self._attr_messages(g.attrs)))
        return header, tree_addr, heap_addr

    def file_chunks(self, root: Group) -> list:
        header, tree, heap = self._group(root)
        self._alloc(b'')                              # 8-byte end of file
        self.chunks[0] = (
            _SIGNATURE + struct.pack('<BBBBBBBB', 0, 0, 0, 0, 0, 8, 8, 0)
            + struct.pack('<HHI', _LEAF_K, _INTERNAL_K, 0)
            + struct.pack('<QQQQ', 0, _UNDEF, self.size, _UNDEF)
            + struct.pack('<QQI4xQQ', 0, header, 1, tree, heap))
        return self.chunks


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        if buf[:8] != _SIGNATURE:
            raise OSError('not an HDF5 file')
        if buf[8] != 0:
            raise NotImplementedError(f'HDF5 superblock version {buf[8]}')
        if buf[13] != 8 or buf[14] != 8:
            raise NotImplementedError('offsets and lengths of 8 bytes only')
        self.root_header = struct.unpack_from('<Q', buf, 64)[0]

    def root(self) -> Group:
        return self._object(self.root_header)

    def _messages(self, addr: int):
        buf = self.buf
        if buf[addr] != 1:
            raise NotImplementedError('version-1 object headers only')
        n, size = struct.unpack_from('<H4xI', buf, addr + 2)
        blocks, out = [(addr + 16, size)], []
        while blocks and len(out) < n:
            p, size = blocks.pop(0)
            end = p + size
            while p + 8 <= end and len(out) < n:
                kind, msize, flags = struct.unpack_from('<HHB', buf, p)
                if flags & 0x02:
                    raise NotImplementedError('shared header messages')
                data_pos = p + 8
                if kind == _CONTINUATION:
                    blocks.append(struct.unpack_from('<QQ', buf, data_pos))
                out.append((kind, data_pos))
                p = data_pos + msize
        return out

    def _attribute(self, pos: int):
        buf = self.buf
        version = buf[pos]
        nsize, tsize, ssize = struct.unpack_from('<HHH', buf, pos + 2)
        p = pos + (8 if version < 3 else 9)
        pad = (lambda n: -(-n // 8) * 8) if version == 1 else (lambda n: n)
        name = buf[p:p + nsize].split(b'\0')[0].decode()
        p += pad(nsize)
        dt, _ = _decode_dtype(buf, p)
        p += pad(tsize)
        shape = _decode_dataspace(buf, p)
        p += pad(ssize)
        if shape is None:
            return name, None
        value = np.frombuffer(buf, dt, int(np.prod(shape)), p).reshape(shape)
        if dt.kind == 'S' and value.shape == ():
            return name, value.item().rstrip(b'\0').decode(errors='replace')
        return name, (value.copy() if value.shape else value[()])

    def _object(self, addr: int):
        msgs = self._messages(addr)
        kinds = {k for k, _ in msgs}
        attrs = {}
        for kind, pos in msgs:
            if kind == _ATTRIBUTE:
                try:
                    name, value = self._attribute(pos)
                except NotImplementedError:
                    continue                 # e.g. variable-length strings
                attrs[name] = value
        if _SYMBOL_TABLE in kinds:
            node = Group()
            pos = dict((k, p) for k, p in msgs)[_SYMBOL_TABLE]
            tree, heap = struct.unpack_from('<QQ', self.buf, pos)
            for name, child in self._group_entries(tree, heap):
                node.members[name] = self._object(child)
        elif {_DATASPACE, _DATATYPE, _LAYOUT} <= kinds:
            node = Dataset(self._dataset_data(dict(msgs)))
        else:
            raise NotImplementedError('objects other than symbol-table '
                                      'groups and datasets')
        node.attrs = attrs
        return node

    def _dataset_data(self, pos: dict) -> np.ndarray:
        buf = self.buf
        shape = _decode_dataspace(buf, pos[_DATASPACE])
        if shape is None:
            shape = (0,)
        dt, _ = _decode_dtype(buf, pos[_DATATYPE])
        p = pos[_LAYOUT]
        if buf[p] != 3:
            raise NotImplementedError('data layout message version 3 only')
        count = int(np.prod(shape))
        if buf[p + 1] == 0:                                   # compact
            return np.frombuffer(buf, dt, count, p + 4).reshape(shape).copy()
        if buf[p + 1] != 1:
            raise NotImplementedError('chunked datasets')
        addr, _ = struct.unpack_from('<QQ', buf, p + 2)
        if addr == _UNDEF or count == 0:
            return np.zeros(shape, dt)
        return np.frombuffer(buf, dt, count, addr).reshape(shape).copy()

    def _group_entries(self, tree: int, heap: int):
        buf = self.buf
        data = struct.unpack_from('<Q', buf, heap + 24)[0]
        name_at = lambda off: buf[data + off:buf.index(b'\0', data + off)]
        sig, _, level, n = struct.unpack_from('<4sBBH', buf, tree)
        if sig != b'TREE':
            raise OSError('corrupt group B-tree')
        for i in range(n):
            child = struct.unpack_from('<Q', buf, tree + 24 + 8 + 16 * i)[0]
            if level > 0:
                yield from self._group_entries(child, heap)
                continue
            if buf[child:child + 4] != b'SNOD':
                raise OSError('corrupt symbol-table node')
            for j in range(struct.unpack_from('<H', buf, child + 6)[0]):
                off, obj = struct.unpack_from('<QQ', buf, child + 8 + 40 * j)
                yield name_at(off).decode(), obj

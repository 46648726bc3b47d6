"""HDF5 files for the simulation's input and output, in numpy.

A small reader and writer of the part of HDF5 the simulation uses, so that
a run needs nothing beyond PyTorch and numpy (no h5py, no libhdf5): groups,
datasets of fixed-point, floating-point, boolean, fixed-length string and
compound (with array members) types, and attributes of the same types
(scalars, arrays and strings).

Layouts, read and written with the file-format structures of HDF5 1.8's
default layout (superblock 0, version-1 object headers, symbol-table
groups), which is also what h5py writes by default:

- contiguous and compact datasets;
- chunked datasets (layout message 3, class 2) indexed by a version-1
  B-tree of any depth, with the filters deflate (gzip), shuffle and LZF
  (h5py's filter 32000, ``io/lzf.py``), partial edge chunks stored full
  size, the per-chunk filter mask, and dataspaces with maximum dimensions
  (``maxshape``), as larnd-sim, edep-sim and the JAX package's CLI write
  every appended dataset.

A :class:`File` opened for reading maps the file into memory and decodes
a dataset at its first access.  Opened for writing, it creates a partial
file beside the path at once (:func:`partial_path`) and moves it onto the
path when it is closed, so a file already at the path stays whole until
then.  A chunked dataset (``maxshape``, ``chunks``, ``compression`` or
``shuffle``, as h5py takes them) writes each full chunk, filtered, at the
file's end as soon as a write reaches its last row, and keeps in memory
only the rows after its last full chunk.  The rest is written when the
file is closed: the contiguous datasets, the partial last chunks, the
chunk B-trees, the object headers and groups, and at last the superblock.
A file left by an error (``with`` block or failed close) is removed; one
that is never closed (a process that dies) stays at its partial path,
unreadable.  Newer superblocks, layout message 4 (``libver='latest'``)
and other filters raise.
"""
from __future__ import annotations

import itertools
import mmap
import os
import struct
import zlib

import numpy as np

from . import lzf

_SIGNATURE = b'\x89HDF\r\n\x1a\n'
_UNDEF = 0xFFFFFFFFFFFFFFFF
#: symbol-table node capacity 2*LEAF_K; B-tree node capacity 2*INTERNAL_K
_LEAF_K, _INTERNAL_K = 32, 16
_SNOD_SIZE = 8 + 2 * _LEAF_K * 40
_TREE_SIZE = 24 + 2 * _INTERNAL_K * 8 + (2 * _INTERNAL_K + 1) * 8
#: chunk B-tree nodes hold up to 2*CHUNK_K chunks (superblock 0's K)
_CHUNK_K = 32

# object-header message types
_DATASPACE, _DATATYPE, _LAYOUT, _FILTERS = 0x01, 0x03, 0x08, 0x0B
_ATTRIBUTE = 0x0C
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11

FILTER_DEFLATE, FILTER_SHUFFLE = 1, 2
#: bytes of a chunk sized by the writer: whole rows of the dataset, so
#: that an appended dataset streams one chunk per this many bytes
CHUNK_BYTES = 1 << 20
#: chunks filtered in one call when a large block of rows is written
_ENCODE_BATCH = 64


# --------------------------------------------------------------------------
# in-memory tree
# --------------------------------------------------------------------------

class Dataset:
    """A dataset held in memory as a numpy array (stored contiguous when
    written).  A dataset read from a file is decoded at its first access
    and carries its storage's ``chunks``, ``compression``,
    ``compression_opts``, ``shuffle`` and ``maxshape`` as h5py names them."""

    chunks = compression = compression_opts = maxshape = None
    shuffle = False
    #: bytes the data takes in the file it was read from
    _stored = None

    def __init__(self, data=None, *, load=None, shape=None, dtype=None,
                 name: str = ''):
        self.name = name
        self.attrs: dict = {}
        self._load = load
        if load is None:
            self._set(np.array(data))
        else:
            self._shape, self._dtype = tuple(shape), np.dtype(dtype)

    def _set(self, arr: np.ndarray) -> None:
        self._data = arr
        self._load = None

    @property
    def data(self) -> np.ndarray:
        if self._load is not None:
            self._set(self._load())
        return self._data

    @property
    def shape(self):
        return self._shape if self._load is not None else self._data.shape

    @property
    def dtype(self):
        return self._dtype if self._load is not None else self._data.dtype

    def __len__(self):
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        return self.data if dtype is None else self.data.astype(dtype)

    def __getitem__(self, key):
        return self.data[key]

    def __setitem__(self, key, value):
        self.data[key] = value

    def storage_size(self) -> int:
        """Bytes of the data in the file (as h5py's
        ``id.get_storage_size()``): a chunked dataset's stored chunks, after
        their filters."""
        return self.data.nbytes if self._stored is None else self._stored

    def resize(self, n: int, axis: int = 0) -> None:
        """Grow or shrink the first axis in memory; new rows are zero."""
        _check_axis(axis, self.shape)
        out = np.zeros((n,) + self.shape[1:], self.dtype)
        out[:min(n, len(self))] = self.data[:n]
        self._set(out)


def _check_axis(axis: int, shape) -> None:
    if axis != 0 or len(shape) == 0:
        raise NotImplementedError('resize along the first axis only')


class ChunkedDataset(Dataset):
    """A chunked dataset of a file open for writing.

    Rows are committed a whole chunk at a time: when a write reaches the
    dataset's last row (an append), every full chunk before the last
    partial one is filtered and written at the file's end.  Only the rows
    after the last committed chunk stay in memory, in ``_buf`` (a buffer
    that doubles as it grows, up to two chunks unless one write brings
    more).  Writing into, or shrinking below, committed rows raises.
    Reading returns committed rows from the file."""

    def __init__(self, file: 'File', data: np.ndarray, maxshape, chunks,
                 compression, compression_opts, shuffle, name: str):
        self.name = name
        self.attrs = {}
        self._load = None
        self._file = file
        self._dtype = data.dtype
        self._rows = data.shape[1:]
        if data.ndim == 0:
            raise ValueError(f'{name}: a scalar dataset cannot be chunked')
        self.maxshape = (tuple(data.shape) if maxshape is None
                         else tuple(maxshape))
        if len(self.maxshape) != data.ndim:
            raise ValueError(f'{name}: maxshape {self.maxshape} against '
                             f'shape {data.shape}')
        self._auto = chunks in (None, True)
        if self._auto:
            row = self._dtype.itemsize * int(np.prod(
                [max(s, 1) for s in self._rows]))
            n0 = max(CHUNK_BYTES // row, 1)
            if self.maxshape[0] is not None:
                n0 = min(n0, max(self.maxshape[0], 1))
            chunks = (n0,) + tuple(max(s, 1) for s in self._rows)
        self.chunks = tuple(int(c) for c in chunks)
        if len(self.chunks) != data.ndim or min(self.chunks) < 1:
            raise ValueError(f'{name}: chunks {self.chunks} against shape '
                             f'{data.shape}')
        if isinstance(compression, int) and not isinstance(compression,
                                                           bool):
            compression, compression_opts = 'gzip', compression
        if compression == 'gzip':
            compression_opts = 4 if compression_opts is None \
                else int(compression_opts)
        elif compression not in (None, 'lzf') or compression_opts is not None:
            raise NotImplementedError(
                f'{name}: compression {compression!r} '
                f'({compression_opts!r}); this writer has gzip and lzf')
        if compression == 'lzf':
            lzf.library()                # no LZF without its codec
        self.compression, self.compression_opts = compression, \
            compression_opts
        self.shuffle = bool(shuffle)
        self._n = 0                      # rows
        self._done = 0                   # rows committed to the file
        self._index: list = []           # (offsets, address, size, mask)
        self._buf = np.zeros((0,) + self._rows, self._dtype)
        self.append(data)

    shape = property(lambda self: (self._n,) + self._rows)
    dtype = property(lambda self: self._dtype)

    @property
    def data(self) -> np.ndarray:
        """Every row: the committed ones read back, then the tail."""
        out = np.zeros(self.shape, self._dtype)
        out[self._done:] = self._tail
        if self._done:
            fd = self._file._fd
            self._file._check_open()
            _fill_chunks(out, self.chunks, self.pipeline(), (
                (off, os.pread(fd, size, addr), mask)
                for off, addr, size, mask in self._index))
        return out

    _tail = property(lambda self: self._buf[:self._n - self._done])

    def storage_size(self) -> int:
        """Bytes of the chunks written so far."""
        return sum(size for _, _, size, _ in self._index)

    def pipeline(self) -> list:
        """The filters as (id, flags, client data), in h5py's order."""
        chunk_bytes = self._dtype.itemsize * int(np.prod(self.chunks))
        out = []
        if self.shuffle:
            out.append((FILTER_SHUFFLE, 1, (self._dtype.itemsize,)))
        if self.compression == 'gzip':
            out.append((FILTER_DEFLATE, 1, (self.compression_opts,)))
        elif self.compression == 'lzf':
            out.append((lzf.FILTER_LZF, 1, lzf.LZF_CLIENT + (chunk_bytes,)))
        return out

    def _rows_of(self, key):
        """(first, last + 1) row a key's first axis reaches, or None for
        none; a positive-step slice, an int, or any numpy index."""
        k0 = key[0] if isinstance(key, tuple) and key else key
        if isinstance(k0, (int, np.integer)):
            r = range(self._n)[k0]
            return r, r + 1
        if isinstance(k0, slice):
            r = range(self._n)[k0]
            if not len(r):
                return None
            lo, hi = (r[0], r[-1]) if r.step > 0 else (r[-1], r[0])
            return lo, hi + 1
        rows = np.arange(self._n)[k0]
        return (int(rows.min()), int(rows.max()) + 1) if rows.size else None

    def _shifted(self, key):
        """``key`` on the tail: its first axis moved down by the committed
        rows."""
        d = self._done
        tup = isinstance(key, tuple)
        k0, rest = (key[0], key[1:]) if tup and key else (key, ())
        if isinstance(k0, (int, np.integer)):
            k0 = range(self._n)[k0] - d
        elif isinstance(k0, slice) and (k0.step or 1) > 0:
            r = range(self._n)[k0]
            k0 = slice(r.start - d, max(r.stop - d, 0), r.step)
        else:
            k0 = np.arange(self._n)[k0] - d
        return (k0,) + rest if tup else k0

    def __getitem__(self, key):
        rows = self._rows_of(key)
        if rows is None or rows[0] >= self._done:
            return self._tail[self._shifted(key)]
        return self.data[key]

    def __setitem__(self, key, value):
        rows = self._rows_of(key)
        if rows is None:
            return
        if rows[0] < self._done:
            raise ValueError(f'{self.name}: rows below {self._done} are '
                             'already written to the file')
        self._tail[self._shifted(key)] = value
        if rows[1] == self._n:
            self._commit_full()

    def _grow(self, t: int) -> None:
        """Room for ``t`` tail rows."""
        if t > len(self._buf):
            cap = max(t, min(2 * len(self._buf), 2 * self.chunks[0]))
            buf = np.empty((cap,) + self._rows, self._dtype)
            buf[:len(self._tail)] = self._tail
            self._buf = buf

    def resize(self, n: int, axis: int = 0) -> None:
        """Grow or shrink the first axis; new rows are zero."""
        _check_axis(axis, self.shape)
        if self.maxshape[0] is not None and n > self.maxshape[0]:
            raise ValueError(f'{self.name}: {n} rows exceed maxshape '
                             f'{self.maxshape}')
        if n < self._done:
            raise ValueError(f'{self.name}: cannot shrink below the '
                             f'{self._done} rows already written')
        t_old, t = len(self._tail), n - self._done
        self._grow(t)
        self._buf[t_old:t] = 0
        self._n = n

    def append(self, rows) -> None:
        """Add ``rows`` after the last row; full chunks go to the file as
        they fill, straight from ``rows`` where they start on a chunk."""
        rows = np.asarray(rows)
        if rows.dtype != self._dtype:
            cast = np.zeros(rows.shape, self._dtype)
            cast[...] = rows
            rows = cast
        if rows.shape[1:] != self._rows:
            raise ValueError(f'{self.name}: rows of shape {rows.shape[1:]}, '
                             f'the dataset\'s are {self._rows}')
        if self.maxshape[0] is not None and \
                self._n + len(rows) > self.maxshape[0]:
            raise ValueError(f'{self.name}: {self._n + len(rows)} rows '
                             f'exceed maxshape {self.maxshape}')
        self._commit_full()
        c0, i = self.chunks[0], 0
        t = len(self._tail)
        if t:
            i = min(len(rows), c0 - t)
            self._grow(t + i)
            self._buf[t:t + i] = rows[:i]
            self._n += i
            self._commit_full()
        k = (len(rows) - i) // c0 * c0
        if k:
            self._write_rows(rows[i:i + k])
            self._n += k
            i += k
        if i < len(rows):
            t = len(self._tail)
            self._grow(t + len(rows) - i)
            self._buf[t:t + len(rows) - i] = rows[i:]
            self._n += len(rows) - i

    def _commit_full(self) -> None:
        """Write the tail's full chunks; keep the rest."""
        t = len(self._tail)
        m = t // self.chunks[0] * self.chunks[0]
        if not m:
            return
        self._write_rows(self._buf[:m])
        rest = self._buf[m:t]
        if len(self._buf) > 2 * self.chunks[0]:
            self._buf = np.empty((2 * self.chunks[0],) + self._rows,
                                 self._dtype)
        self._buf[:len(rest)] = rest

    def _write_rows(self, rows: np.ndarray) -> None:
        """Filter and write whole chunks of rows that follow the committed
        ones (len(rows) a multiple of the chunk's rows)."""
        c = self.chunks
        if not rows.size:
            self._done += len(rows)
            return
        rows = np.ascontiguousarray(rows)
        chunk_bytes = self._dtype.itemsize * int(np.prod(c))
        offsets, blocks = [], []
        if c[1:] == self._rows:
            raw = rows.reshape(-1).view(np.uint8).reshape(-1, chunk_bytes)
            offsets = [(self._done + j * c[0],) + (0,) * len(self._rows)
                       for j in range(len(raw))]
        else:
            grid = [range(0, s, ci) for s, ci in zip(self._rows, c[1:])]
            for j in range(0, len(rows), c[0]):
                for corner in itertools.product(*grid):
                    src = rows[(slice(j, j + c[0]),) + tuple(
                        slice(o, o + ci) for o, ci in zip(corner, c[1:]))]
                    block = np.zeros(c, self._dtype)
                    block[tuple(slice(0, s) for s in src.shape)] = src
                    blocks.append(block.reshape(-1).view(np.uint8))
                    offsets.append((self._done + j,) + corner)
            raw = np.stack(blocks)
        pipe = self.pipeline()
        for b in range(0, len(raw), _ENCODE_BATCH):
            for off, (stream, mask) in zip(
                    offsets[b:b + _ENCODE_BATCH],
                    _encode(pipe, raw[b:b + _ENCODE_BATCH])):
                addr = self._file._put(stream)
                self._index.append((off, addr, len(stream), mask))
        self._done += len(rows)

    def _finish(self) -> None:
        """Commit every row: the full chunks, then the partial last one
        (padded with zeros).  A dataset sized by the writer whose rows fit
        in its first chunk gets a chunk of its own length."""
        self._commit_full()
        t = len(self._tail)
        if not t:
            return
        if self._auto and not self._done:
            self.chunks = (t,) + self.chunks[1:]
        pad = np.zeros((self.chunks[0],) + self._rows, self._dtype)
        pad[:t] = self._tail
        self._write_rows(pad)
        self._done = self._n


class Group:
    """A group: named datasets and groups, plus attributes.  In a file open
    for writing, a chunked dataset streams to that file."""

    def __init__(self, file: 'File | None' = None, name: str = '/'):
        self.members: dict = {}
        self.attrs: dict = {}
        self._file = file
        self.name = name

    def _walk(self, name: str, create: bool = False):
        parts = [p for p in name.split('/') if p]
        node = self
        for p in parts[:-1]:
            if p not in node.members:
                if not create:
                    raise KeyError(name)
                node.members[p] = Group(self._file, _join(node.name, p))
            node = node.members[p]
            if not isinstance(node, Group):
                raise KeyError(name)
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

    def __delitem__(self, name: str) -> None:
        """Unlink a dataset or group.  In a file being written, chunks it
        already wrote stay in the file, unreferenced, as HDF5 leaves the
        space of a deleted object."""
        parent, leaf = self._walk(name)
        del parent.members[leaf]

    def keys(self):
        return self.members.keys()

    def _add(self, name: str, make):
        parent, leaf = self._walk(name, create=True)
        if leaf in parent.members:
            raise ValueError(f'{name} already exists')
        obj = parent.members[leaf] = make(_join(parent.name, leaf))
        return obj

    def create_group(self, name: str) -> 'Group':
        return self._add(name, lambda path: Group(self._file, path))

    def create_dataset(self, name: str, data=None, *, shape=None, dtype=None,
                       maxshape=None, chunks=None, compression=None,
                       compression_opts=None, shuffle=None) -> Dataset:
        """A dataset from ``data`` (or zeros of ``shape`` and ``dtype``).
        With ``maxshape``, ``chunks``, ``compression`` (``'gzip'``, a gzip
        level 0-9, or ``'lzf'``) or ``shuffle``, taken as h5py takes
        them, it is chunked: only such a dataset can be resized in a file
        being written, and only along its first axis.  Chunks the caller
        does not give hold whole rows, ``CHUNK_BYTES`` of them."""
        data = np.zeros(shape, dtype) if data is None else np.asarray(
            data, dtype)
        chunked = (maxshape is not None or chunks not in (None, False)
                   or compression is not None or bool(shuffle))
        if chunked and self._file is not None:
            return self._add(name, lambda path: ChunkedDataset(
                self._file, data, maxshape, chunks, compression,
                compression_opts, shuffle, path))
        return self._add(name, lambda path: Dataset(data, name=path))


def _join(parent: str, leaf: str) -> str:
    return parent.rstrip('/') + '/' + leaf


class File(Group):
    """An HDF5 file: mapped and read at open ('r'), or created at open and
    completed at close ('w')."""

    def __init__(self, path, mode: str = 'r'):
        super().__init__()
        self._fd = None
        if mode not in ('r', 'w'):
            raise ValueError(
                f'mode {mode!r} is not supported: io.h5.File reads a file '
                "('r') or writes a new one ('w')")
        self.path = os.fspath(path)
        self.mode = mode
        if mode == 'w':
            # a new file, moved onto the path at close: a file there stays
            # whole until then, and a File still reading it keeps its mapping
            self._part = partial_path(self.path)
            if os.path.lexists(self._part):
                os.remove(self._part)
            self._fd = os.open(self._part, os.O_RDWR | os.O_CREAT | os.O_EXCL,
                               0o644)
            self._file = self
            self._eof = 96                       # the superblock, last
            return
        with open(self.path, 'rb') as f:
            try:
                buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            except ValueError as exc:                   # an empty file
                raise OSError(f'{self.path}: not an HDF5 file') from exc
        root = _Reader(buf).root()
        self.members, self.attrs = root.members, root.attrs

    def _check_open(self) -> None:
        if self._fd is None:
            raise ValueError(f'{self.path} is closed')

    def _put(self, data) -> int:
        """Write ``data`` at the file's end (8-byte aligned); its address."""
        self._check_open()
        addr = self._eof + -self._eof % 8
        _pwrite(self._fd, data, addr)
        self._eof = addr + memoryview(data).nbytes
        return addr

    def close(self) -> None:
        """Write the rest of the file and move it onto the path; if that
        fails, the partial file is removed."""
        if self.mode != 'w':
            return
        self._check_open()
        try:
            for ds in _datasets(self):
                if isinstance(ds, ChunkedDataset):
                    ds._finish()
            writer = _Writer(self._eof)
            superblock = writer.file_chunks(self)
            pos = self._eof
            for piece in writer.chunks:
                _pwrite(self._fd, piece, pos)
                pos += memoryview(piece).nbytes
            _pwrite(self._fd, superblock, 0)
        except BaseException:
            self.discard()
            raise
        os.close(self._fd)
        self._fd = None
        os.replace(self._part, self.path)
        self.mode = 'r'

    def discard(self) -> None:
        """Stop writing and remove the partial file: the path keeps what
        it held before this File was opened."""
        if self.mode == 'w' and self._fd is not None:
            os.close(self._fd)
            self._fd = None
            os.remove(self._part)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            self.discard()


def partial_path(path) -> str:
    """Where ``File(path, 'w')`` in this process writes until it is
    closed."""
    return f'{os.fspath(path)}.{os.getpid()}.part'


def _datasets(g: Group):
    for m in g.members.values():
        if isinstance(m, Group):
            yield from _datasets(m)
        else:
            yield m


def _pwrite(fd: int, data, pos: int) -> None:
    if isinstance(data, np.ndarray):
        data = data.reshape(-1).view(np.uint8)
    view = memoryview(data).cast('B')
    while len(view):
        n = os.pwrite(fd, view, pos)
        view, pos = view[n:], pos + n


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
    end = buf.find(b'\0', p)
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


def _encode_dataspace(shape, maxshape=None) -> bytes:
    # version 1; rank 0 is a scalar; flag 1: maximum dimensions follow
    out = (struct.pack('<BBBB4x', 1, len(shape), 0 if maxshape is None
                       else 1, 0)
           + b''.join(struct.pack('<Q', n) for n in shape))
    if maxshape is not None:
        out += b''.join(struct.pack('<Q', _UNDEF if n is None else n)
                        for n in maxshape)
    return out


def _decode_dataspace(buf, pos: int, with_max: bool = False):
    """The shape, () for a scalar, None for a null dataspace; with
    ``with_max`` also the maximum dimensions (None: unlimited; the shape
    when the message has none)."""
    version, rank, flags = buf[pos], buf[pos + 1], buf[pos + 2]
    if version == 1:
        p = pos + 8
    else:
        if buf[pos + 3] == 2:
            return (None, None) if with_max else None
        p = pos + 4
    shape = struct.unpack_from(f'<{rank}Q', buf, p)
    if not with_max:
        return shape
    maxshape = shape
    if flags & 1:
        maxshape = tuple(None if n == _UNDEF else n for n in
                         struct.unpack_from(f'<{rank}Q', buf, p + 8 * rank))
    return shape, maxshape


def _as_array(value):
    """An attribute value as an array the writer can encode."""
    if isinstance(value, str):
        value = value.encode()
    if isinstance(value, bytes):
        return np.array(value, dtype=f'S{max(len(value), 1)}')
    return np.asarray(value)


# --------------------------------------------------------------------------
# filters
# --------------------------------------------------------------------------

_FILTER_NAMES = {FILTER_DEFLATE: b'deflate', FILTER_SHUFFLE: b'shuffle',
                 lzf.FILTER_LZF: b'lzf'}


def _encode_filters(pipeline) -> bytes:
    """Filter pipeline message, version 1, with h5py's names."""
    out = struct.pack('<BB6x', 1, len(pipeline))
    for fid, flags, cd in pipeline:
        name = _pad8(_FILTER_NAMES[fid] + b'\0')
        out += (struct.pack('<HHHH', fid, len(name), flags, len(cd)) + name
                + struct.pack(f'<{len(cd)}I', *cd) + bytes(4 * (len(cd) % 2)))
    return out


def _decode_filters(buf, pos: int) -> list:
    """[(filter id, flags, client data)] of a pipeline message (v1, v2)."""
    version, n = buf[pos], buf[pos + 1]
    p = pos + (8 if version == 1 else 2)
    out = []
    for _ in range(n):
        fid = struct.unpack_from('<H', buf, p)[0]
        p += 2
        nlen = 0
        if version == 1 or fid >= 256:
            nlen = struct.unpack_from('<H', buf, p)[0]
            p += 2
        flags, ncd = struct.unpack_from('<HH', buf, p)
        p += 4 + nlen
        out.append((fid, flags, struct.unpack_from(f'<{ncd}I', buf, p)))
        p += 4 * ncd + (4 * (ncd % 2) if version == 1 else 0)
    return out


def _fused_lzf(pipeline):
    """Shuffle's record bytes (0: no shuffle) when the pipeline is LZF,
    alone or after shuffle; else None."""
    ids = [fid for fid, _, _ in pipeline]
    if ids == [lzf.FILTER_LZF]:
        return 0
    if ids == [FILTER_SHUFFLE, lzf.FILTER_LZF]:
        return pipeline[0][2][0]
    return None


def _shuffle(data, rec: int) -> np.ndarray:
    """HDF5's byte shuffle of whole records of ``rec`` bytes: byte plane p
    holds byte p of every record.  The LZF pipeline's shuffle is the C++
    one of ``csrc/host/lzf_core.h``; the two must agree (and are tested
    against each other)."""
    return np.ascontiguousarray(
        np.frombuffer(data, np.uint8).reshape(-1, rec).T).reshape(-1)


def _unshuffle(data, rec: int) -> np.ndarray:
    """The inverse of :func:`_shuffle`; bytes after the last whole record
    stay as they are, as HDF5 leaves them (``lzf_core.h``'s unshuffle does
    the same)."""
    flat = np.frombuffer(data, np.uint8)
    whole = len(flat) // rec * rec
    return np.concatenate([flat[:whole].reshape(rec, -1).T.reshape(-1),
                           flat[whole:]])


def _encode(pipeline, raw: np.ndarray) -> list:
    """[(stored bytes, filter mask)] of the chunks ``raw`` (n, chunk bytes)
    uint8.  A filter that does not shrink a chunk is skipped for it (its
    mask bit set), as the HDF5 pipeline skips an optional filter that
    fails."""
    rec = _fused_lzf(pipeline)
    if rec is not None:
        streams, sizes, skipped = lzf.encode_chunks(raw, rec)
        bit = 1 << (len(pipeline) - 1)
        return [(streams[i, :sizes[i]], bit if skipped[i] else 0)
                for i in range(len(raw))]
    out = []
    for row in raw:
        data, mask = row, 0
        for i, (fid, _, cd) in enumerate(pipeline):
            if fid == FILTER_SHUFFLE:
                data = _shuffle(data, cd[0])
            elif fid == FILTER_DEFLATE:
                packed = zlib.compress(data, cd[0])
                if len(packed) < memoryview(data).nbytes:
                    data = packed
                else:
                    mask |= 1 << i
            else:
                raise NotImplementedError(f'HDF5 filter {fid} on write')
        out.append((data, mask))
    return out


def _decode(pipeline, stream, mask: int, nbytes: int) -> np.ndarray:
    """A chunk's ``nbytes`` (uint8) from its stored bytes."""
    rec = _fused_lzf(pipeline)
    if rec is not None:
        if rec and mask & 1:                          # shuffle skipped
            rec = 0
        return lzf.decode(stream, nbytes, rec,
                          skip_lzf=bool(mask >> (len(pipeline) - 1) & 1))
    data = stream
    for i in reversed(range(len(pipeline))):
        fid, _, cd = pipeline[i]
        if mask >> i & 1:
            continue
        if fid == FILTER_DEFLATE:
            data = zlib.decompress(data)
        elif fid == FILTER_SHUFFLE:
            data = _unshuffle(data, cd[0])
        else:
            raise NotImplementedError(f'HDF5 filter {fid} (this reader has '
                                      'deflate, shuffle and lzf)')
    data = np.frombuffer(data, np.uint8)
    if len(data) != nbytes:
        raise OSError(f'corrupt chunk: {len(data)} bytes, {nbytes} expected')
    return data


def _fill_chunks(out: np.ndarray, chunks, pipeline, stored) -> None:
    """Decode the chunks ``stored`` ((element offsets, bytes, filter mask)
    each) into ``out``; the parts of edge chunks outside it are dropped."""
    nbytes = out.dtype.itemsize * int(np.prod(chunks))
    for offsets, stream, mask in stored:
        if any(o >= s for o, s in zip(offsets, out.shape)):
            continue
        block = _decode(pipeline, stream, mask, nbytes).view(
            out.dtype).reshape(chunks)
        dst = tuple(slice(o, min(o + c, s))
                    for o, c, s in zip(offsets, chunks, out.shape))
        out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

class _Writer:
    """Serializes a :class:`Group` tree (children before their parents),
    from the file offset ``start`` on, into a list of byte chunks; dataset
    contents are not copied.  :meth:`file_chunks` returns the
    superblock."""

    def __init__(self, start: int):
        self.chunks = []
        self.size = start

    def _alloc(self, data) -> int:
        pad = -self.size % 8
        if pad:
            self.chunks.append(bytes(pad))
        addr = self.size + pad
        self.chunks.append(data)
        self.size = addr + memoryview(data).nbytes
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
        if isinstance(ds, ChunkedDataset):
            return self._chunked(ds)
        data = np.ascontiguousarray(ds.data)
        addr = (self._alloc(data.reshape(-1).view(np.uint8)) if data.nbytes
                else _UNDEF)
        return self._alloc(self._header(
            [(_DATASPACE, _encode_dataspace(data.shape)),
             (_DATATYPE, _encode_dtype(data.dtype)),
             (_LAYOUT, struct.pack('<BBQQ', 3, 1, addr, data.nbytes))]
            + self._attr_messages(ds.attrs)))

    def _chunked(self, ds: ChunkedDataset) -> int:
        rank = len(ds.shape)
        dims = ds.chunks + (ds.dtype.itemsize,)
        tree = self._chunk_tree(ds._index, dims) if ds._index else _UNDEF
        pipeline = ds.pipeline()
        return self._alloc(self._header(
            [(_DATASPACE, _encode_dataspace(ds.shape, ds.maxshape)),
             (_DATATYPE, _encode_dtype(ds.dtype)),
             (_LAYOUT, struct.pack(f'<BBBQ{rank + 1}I', 3, 2, rank + 1,
                                   tree, *dims))]
            + ([(_FILTERS, _encode_filters(pipeline))] if pipeline else [])
            + self._attr_messages(ds.attrs)))

    def _chunk_tree(self, index: list, dims) -> int:
        """Version-1 B-tree (node type 1) over the chunks in ``index``
        (in offset order), 2*_CHUNK_K children a node, as many levels as
        it takes; the root's address."""
        nodes = 2 * _CHUNK_K
        key_size = 8 + 8 * len(dims)
        node_size = 24 + nodes * 8 + (nodes + 1) * key_size

        def key(size, mask, offsets):
            return struct.pack(f'<II{len(dims)}Q', size, mask, *offsets, 0)

        # keys of level 0: each chunk's own; a node's last key is the next
        # node's first, and past the last chunk its offsets plus one chunk
        # (with the element size last, as the HDF5 library writes it)
        entries = [(key(size, mask, off), addr)
                   for off, addr, size, mask in index]
        end = struct.pack(f'<II{len(dims)}Q', 0, 0, *(
            o + c for o, c in zip(index[-1][0], dims)), dims[-1])
        level = 0
        while True:
            groups = [entries[i:i + nodes]
                      for i in range(0, len(entries), nodes)]
            base = self.size + -self.size % 8
            parents = []
            for i, group in enumerate(groups):
                more = i + 1 < len(groups)
                body = b''.join(k + struct.pack('<Q', child)
                                for k, child in group)
                body += groups[i + 1][0][0] if more else end
                node = struct.pack(
                    '<4sBBHQQ', b'TREE', 1, level, len(group),
                    base + (i - 1) * node_size if i else _UNDEF,
                    base + (i + 1) * node_size if more else _UNDEF) + body
                addr = self._alloc(node.ljust(node_size, b'\0'))
                assert addr == base + i * node_size
                parents.append((group[0][0], addr))
            if len(parents) == 1:
                return parents[0][1]
            entries, level = parents, level + 1

    def _group(self, g: Group) -> tuple[int, int, int]:
        names = sorted(g.members, key=lambda n: n.encode())
        if len(names) > 2 * _LEAF_K:
            raise NotImplementedError(
                f'group {g.name!r} has {len(names)} members; this writer '
                f'puts at most {2 * _LEAF_K} in a group')
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

    def file_chunks(self, root: Group) -> bytes:
        header, tree, heap = self._group(root)
        self._alloc(b'')                              # 8-byte end of file
        return (
            _SIGNATURE + struct.pack('<BBBBBBBB', 0, 0, 0, 0, 0, 8, 8, 0)
            + struct.pack('<HHI', _LEAF_K, _INTERNAL_K, 0)
            + struct.pack('<QQQQ', 0, _UNDEF, self.size, _UNDEF)
            + struct.pack('<QQI4xQQ', 0, header, 1, tree, heap))


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf):
        self.buf = buf
        if len(buf) < 96 or buf[:8] != _SIGNATURE:
            raise OSError('not an HDF5 file')
        if buf[8] != 0:
            raise NotImplementedError(f'HDF5 superblock version {buf[8]}')
        if buf[13] != 8 or buf[14] != 8:
            raise NotImplementedError('offsets and lengths of 8 bytes only')
        self.root_header = struct.unpack_from('<Q', buf, 64)[0]

    def root(self) -> Group:
        return self._object(self.root_header, '/')

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

    def _object(self, addr: int, path: str):
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
            node = Group(name=path)
            pos = dict((k, p) for k, p in msgs)[_SYMBOL_TABLE]
            tree, heap = struct.unpack_from('<QQ', self.buf, pos)
            for name, child in self._group_entries(tree, heap):
                node.members[name] = self._object(child, _join(path, name))
        elif {_DATASPACE, _DATATYPE, _LAYOUT} <= kinds:
            node = self._dataset(dict(msgs), path)
        else:
            raise NotImplementedError('objects other than symbol-table '
                                      'groups and datasets')
        node.attrs = attrs
        return node

    def _dataset(self, pos: dict, path: str) -> Dataset:
        """The dataset's shape, type and storage from its messages; its
        contents are decoded at first access."""
        buf = self.buf
        shape, maxshape = _decode_dataspace(buf, pos[_DATASPACE],
                                            with_max=True)
        if shape is None:
            shape = maxshape = (0,)
        dt, _ = _decode_dtype(buf, pos[_DATATYPE])
        p = pos[_LAYOUT]
        if buf[p] != 3:
            raise NotImplementedError(
                f'{path}: data layout message version {buf[p]} (version 3 '
                'only)')
        count = int(np.prod(shape))
        layout = buf[p + 1]
        if layout == 0:                                       # compact
            load = self._view(dt, count, shape, p + 4)
        elif layout == 1:                                     # contiguous
            addr = struct.unpack_from('<Q', buf, p + 2)[0]
            load = (self._view(dt, count, shape, addr)
                    if addr != _UNDEF and count else
                    lambda: np.zeros(shape, dt))
            if addr == _UNDEF:
                count = 0
        elif layout == 2:
            rank = buf[p + 2] - 1
            tree = struct.unpack_from('<Q', buf, p + 3)[0]
            chunks = struct.unpack_from(f'<{rank}I', buf, p + 11)
            pipeline = (_decode_filters(buf, pos[_FILTERS])
                        if _FILTERS in pos else [])
            index = (list(self._chunk_entries(tree, rank))
                     if tree != _UNDEF else [])

            def load():
                out = np.zeros(shape, dt)
                if count:
                    _fill_chunks(out, chunks, pipeline, (
                        (off, buf[addr:addr + size], mask)
                        for off, addr, size, mask in index))
                return out
            ds = Dataset(load=load, shape=shape, dtype=dt, name=path)
            ds.chunks, ds.maxshape = tuple(chunks), maxshape
            ds._stored = sum(size for _, _, size, _ in index)
            for fid, _, cd in pipeline:
                if fid == FILTER_SHUFFLE:
                    ds.shuffle = True
                elif fid == FILTER_DEFLATE:
                    ds.compression, ds.compression_opts = 'gzip', cd[0]
                elif fid == lzf.FILTER_LZF:
                    ds.compression = 'lzf'
            return ds
        else:
            raise NotImplementedError(f'{path}: data layout class {layout}')
        ds = Dataset(load=load, shape=shape, dtype=dt, name=path)
        ds._stored = count * dt.itemsize
        return ds

    def _view(self, dt, count: int, shape, addr: int):
        return lambda: np.frombuffer(self.buf, dt, count, addr).reshape(
            shape).copy()

    def _chunk_entries(self, addr: int, rank: int):
        """(element offsets, address, stored size, filter mask) of every
        chunk under the chunk B-tree node at ``addr``, in offset order."""
        buf = self.buf
        sig, ntype, level, n = struct.unpack_from('<4sBBH', buf, addr)
        if sig != b'TREE' or ntype != 1:
            raise OSError('corrupt chunk B-tree')
        key = 8 + 8 * (rank + 1)
        p = addr + 24
        for _ in range(n):
            size, mask = struct.unpack_from('<II', buf, p)
            offsets = struct.unpack_from(f'<{rank}Q', buf, p + 8)
            child = struct.unpack_from('<Q', buf, p + key)[0]
            if level > 0:
                yield from self._chunk_entries(child, rank)
            else:
                yield offsets, child, size, mask
            p += key + 8

    def _group_entries(self, tree: int, heap: int):
        buf = self.buf
        data = struct.unpack_from('<Q', buf, heap + 24)[0]

        def name_at(off):
            end = buf.find(b'\0', data + off)
            return buf[data + off:end]
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

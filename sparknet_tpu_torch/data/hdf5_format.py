"""HDF5 files without ``h5py``: the port's own reader and writer.

The card's machine has no ``h5py``, and the port imports none.  This
module reads and writes the part of the *HDF5 File Format Specification*
(version 2.0, the layout libhdf5 1.8+ writes with its default "earliest"
format bounds) that Caffe's libhdf5 calls and h5py write by default, in
pure Python and numpy:

- **Read.**  Superblock versions 0 and 1 (the sizes of offsets and
  lengths taken from the superblock; a user block before it skipped);
  version-1 object headers with continuation blocks; symbol-table groups
  (v1 B-tree type 0, ``SNOD`` nodes, the local heap); the dataspace
  message (rank 0 to N, null); the datatype message for fixed-point and
  IEEE floating-point numbers of either byte order, fixed-length strings
  and variable-length strings (through the global heap, ``GCOL``); the
  layout message version 3, compact, contiguous or chunked (v1 B-tree
  type 1, edge chunks cropped to the dataspace, a missing chunk or an
  undefined address read as the fill value); the filter pipeline with
  deflate (``zlib``), shuffle and fletcher32 (checked), honouring each
  chunk's filter mask; attributes.
- **Refused by name**, naming the version or class and "ROADMAP A6,
  HDF5": superblock versions 2 and 3 (h5py's ``libver="latest"``),
  version-2 object headers, link messages and the fractal heaps behind
  them (new-style groups), shared messages, every other datatype class,
  layout version and filter.
- **Write** (:func:`write`): superblock version 0, symbol-table groups
  (one ``SNOD`` per group, its entries sorted by name bytes as readers
  binary-search them; the superblock's group leaf K is raised to cover
  the largest group), contiguous datasets of the fixed-point and IEEE
  types, scalar datasets, and fixed-length null-terminated strings (what
  ``H5LTmake_dataset_string`` writes for a solverstate's
  ``learned_net``).  Each array's bytes are written once, straight from
  the array.

Large contiguous datasets are read with one copy out of a memory map of
the file (a 244 MB CaffeNet model reads in well under a second), never
element by element.
"""

from __future__ import annotations

import math
import mmap
import os
import struct
import zlib
from typing import Any, Iterator, Mapping

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
HDF5_ITEM = "ROADMAP A6, HDF5"

_DATATYPE_CLASSES = {0: "fixed-point", 1: "floating-point", 2: "time",
                     3: "string", 4: "bitfield", 5: "opaque",
                     6: "compound", 7: "reference", 8: "enumerated",
                     9: "variable-length", 10: "array"}
_FILTERS = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
            5: "nbit", 6: "scaleoffset", 307: "bzip2", 32000: "lzf",
            32001: "blosc", 32004: "lz4", 32015: "zstd"}
# IEEE layouts: size -> (exponent location, exponent size, mantissa
# location, mantissa size, exponent bias)
_IEEE = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127),
         8: (52, 11, 0, 52, 1023)}

# message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0, 1, 2, 3, 4, 5
_LINK, _LAYOUT, _GROUP_INFO, _FILTERS_MSG, _ATTRIBUTE = 6, 8, 10, 11, 12
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 16, 17, 21


class HDF5FormatError(ValueError):
    """The file is not HDF5, or its structures are damaged."""


class HDF5Unsupported(NotImplementedError):
    """A valid HDF5 feature outside what this module reads or writes."""


def _refuse(what: str) -> None:
    raise HDF5Unsupported(
        f"{what} ({HDF5_ITEM}: the port reads superblock v0/v1 files with "
        f"version-1 object headers and symbol-table groups, as Caffe and "
        f"h5py write by default)")


def _round8(n: int) -> int:
    return (n + 7) & ~7


def is_hdf5(path: str) -> bool:
    """True when ``path`` starts with the HDF5 signature."""
    try:
        with open(path, "rb") as f:
            return f.read(8) == SIGNATURE
    except OSError:
        return False


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (``H5_checksum_fletcher32``): 16-bit big-endian
    words summed in blocks of 360, each sum folded after a block, in
    32-bit arithmetic."""
    n = len(data) // 2
    words = np.frombuffer(data, ">u2", n).astype(np.uint64)
    sum1 = sum2 = 0
    for start in range(0, n, 360):
        blk = np.cumsum(words[start:start + 360])
        sum2 = (sum2 + len(blk) * sum1 + int(blk.sum())) & 0xFFFFFFFF
        sum1 += int(blk[-1])
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if len(data) % 2:
        sum1 += data[-1] << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return ((sum2 << 16) | sum1) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class _Type:
    """A parsed datatype message: the numpy dtype of one element as the
    file stores it, and for variable-length strings the vlen flag."""

    __slots__ = ("dtype", "vlen_str", "size")

    def __init__(self, dtype: np.dtype, size: int, vlen_str: bool = False):
        self.dtype, self.size, self.vlen_str = dtype, size, vlen_str


class File:
    """An HDF5 file open for reading: the root :class:`Group`.  Use as a
    context manager, or call :meth:`close`."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            size = os.fstat(self._f.fileno()).st_size
            if size < len(SIGNATURE):
                raise HDF5FormatError(f"{path}: not an HDF5 file "
                                      f"({size} bytes)")
            self._mm = mmap.mmap(self._f.fileno(), 0,
                                 access=mmap.ACCESS_READ)
            self._size = size
            self._gheaps: dict[int, dict[int, bytes]] = {}
            self.root = Group(self, "/", self._superblock())
        except BaseException:
            self.close()
            raise

    # -- the group surface, through the root --------------------------------
    def __getitem__(self, name: str):
        return self.root[name]

    def __contains__(self, name: str) -> bool:
        return name in self.root

    def __iter__(self) -> Iterator[str]:
        return iter(self.root)

    def keys(self) -> list[str]:
        return self.root.keys()

    @property
    def attrs(self) -> dict[str, Any]:
        return self.root.attrs

    def close(self) -> None:
        mm = getattr(self, "_mm", None)
        if mm is not None:
            mm.close()
            self._mm = None
        self._f.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- primitives ----------------------------------------------------------
    def _bytes(self, addr: int, n: int) -> bytes:
        if addr < 0 or addr + n > self._size:
            raise HDF5FormatError(
                f"{self.path}: a structure at {addr} of {n} bytes runs past "
                f"the end of the file ({self._size} bytes)")
        return self._mm[addr:addr + n]

    def _uint(self, addr: int, n: int) -> int:
        return int.from_bytes(self._bytes(addr, n), "little")

    def _off(self, addr: int) -> int:
        return self._uint(addr, self.so)

    def _len(self, addr: int) -> int:
        return self._uint(addr, self.sl)

    def _defined(self, addr: int) -> bool:
        return addr != (1 << (8 * self.so)) - 1

    def _abs(self, addr: int) -> int:
        return self.base + addr

    # -- superblock ----------------------------------------------------------
    def _superblock(self) -> int:
        """Parse the superblock; returns the root group's object header
        address."""
        at = 0
        while at + 8 <= self._size:
            if self._mm[at:at + 8] == SIGNATURE:
                break
            at = 512 if at == 0 else at * 2
        else:
            raise HDF5FormatError(f"{self.path}: no HDF5 signature")
        ver = self._mm[at + 8]
        if ver in (2, 3):
            _refuse(f"{self.path}: superblock version {ver} (h5py's "
                    f"libver='latest' or a newer library's format)")
        if ver not in (0, 1):
            _refuse(f"{self.path}: superblock version {ver}")
        self.so, self.sl = self._mm[at + 13], self._mm[at + 14]
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise HDF5FormatError(
                f"{self.path}: sizes of offsets {self.so} and lengths "
                f"{self.sl}")
        self.leaf_k, self.internal_k = struct.unpack_from(
            "<HH", self._mm, at + 16)
        pos = at + 24 + (4 if ver == 1 else 0)
        self.base = self._off(pos)
        pos += 4 * self.so                  # base, free space, EOF, driver
        # the root group's symbol table entry: its object header
        return self._abs(self._off(pos + self.so))

    # -- object headers --------------------------------------------------------
    def _messages(self, addr: int) -> list[tuple[int, int, int, int]]:
        """(type, flags, data address, size) of every message of the
        version-1 object header at ``addr``, continuation blocks
        followed."""
        if self._bytes(addr, 4) == b"OHDR":
            _refuse(f"{self.path}: version-2 object header at {addr}")
        ver = self._mm[addr]
        if ver != 1:
            _refuse(f"{self.path}: object header version {ver} at {addr}")
        hsize = struct.unpack_from("<I", self._mm, addr + 8)[0]
        chunks = [(addr + 16, hsize)]
        out = []
        while chunks:
            start, length = chunks.pop(0)
            pos, end = start, start + length
            while pos + 8 <= end:
                mtype, msize, mflags = struct.unpack_from(
                    "<HHB", self._mm, pos)
                data = pos + 8
                if data + msize > end:
                    raise HDF5FormatError(
                        f"{self.path}: message at {pos} overruns its "
                        f"object header block")
                if mtype == _CONTINUATION:
                    chunks.append((self._abs(self._off(data)),
                                   self._len(data + self.so)))
                elif mtype != _NIL:
                    out.append((mtype, mflags, data, msize))
                pos = data + msize
        for mtype, mflags, _, _ in out:
            if mflags & 0x02:
                _refuse(f"{self.path}: shared (committed) message of type "
                        f"{mtype}")
            if mtype in (_LINK_INFO, _LINK, _GROUP_INFO):
                _refuse(f"{self.path}: link messages (a new-style group "
                        f"with link storage and fractal heaps)")
        return out

    # -- groups ----------------------------------------------------------------
    def _local_heap(self, addr: int) -> bytes:
        if self._bytes(addr, 4) != b"HEAP":
            raise HDF5FormatError(f"{self.path}: no local heap at {addr}")
        size = self._len(addr + 8)
        data = self._abs(self._off(addr + 8 + 2 * self.sl))
        return self._bytes(data, size)

    def _group_members(self, btree: int, heap: int) -> dict[str, int]:
        names = self._local_heap(heap)
        out: dict[str, int] = {}

        def name_at(off: int) -> str:
            end = names.index(b"\0", off)
            return names[off:end].decode("utf-8")

        def walk(node: int) -> None:
            if self._bytes(node, 4) != b"TREE":
                raise HDF5FormatError(
                    f"{self.path}: no group B-tree node at {node}")
            ntype, level = self._mm[node + 4], self._mm[node + 5]
            if ntype != 0:
                raise HDF5FormatError(
                    f"{self.path}: group B-tree node of type {ntype}")
            used = struct.unpack_from("<H", self._mm, node + 6)[0]
            pos = node + 8 + 2 * self.so + self.sl      # past key 0
            for _ in range(used):
                child = self._abs(self._off(pos))
                pos += self.so + self.sl
                if level:
                    walk(child)
                else:
                    snod(child)

        def snod(addr: int) -> None:
            if self._bytes(addr, 4) != b"SNOD":
                raise HDF5FormatError(
                    f"{self.path}: no symbol table node at {addr}")
            count = struct.unpack_from("<H", self._mm, addr + 6)[0]
            entry = 2 * self.so + 24
            for i in range(count):
                e = addr + 8 + i * entry
                out[name_at(self._off(e))] = self._abs(
                    self._off(e + self.so))

        walk(self._abs(btree))
        return out

    def _node(self, name: str, addr: int):
        msgs = self._messages(addr)
        types = {m[0] for m in msgs}
        if _SYMBOL_TABLE in types:
            return Group(self, name, addr, msgs)
        if _LAYOUT in types:
            return Dataset(self, name, addr, msgs)
        _refuse(f"{self.path}: object {name!r} is neither a symbol-table "
                f"group nor a dataset (messages {sorted(types)})")

    # -- datatypes, dataspaces, data --------------------------------------------
    def _datatype(self, pos: int) -> _Type:
        b0 = self._mm[pos]
        cls = b0 & 0x0F
        bits = self._uint(pos + 1, 3)
        size = struct.unpack_from("<I", self._mm, pos + 4)[0]
        props = pos + 8
        order = ">" if bits & 1 else "<"
        if cls == 0:
            offset, prec = struct.unpack_from("<HH", self._mm, props)
            if size not in (1, 2, 4, 8) or offset or prec != 8 * size:
                _refuse(f"{self.path}: fixed-point datatype of {size} "
                        f"bytes, {prec} bits at offset {offset}")
            kind = "i" if bits & 0x08 else "u"
            return _Type(np.dtype(f"{order}{kind}{size}"), size)
        if cls == 1:
            if bits & 0x40:
                _refuse(f"{self.path}: VAX-order floating-point datatype")
            offset, prec, eloc, esize, mloc, msize, bias = \
                struct.unpack_from("<HHBBBBI", self._mm, props)
            if size not in _IEEE or offset or prec != 8 * size or \
                    (eloc, esize, mloc, msize, bias) != _IEEE[size]:
                _refuse(f"{self.path}: non-IEEE floating-point datatype "
                        f"of {size} bytes")
            return _Type(np.dtype(f"{order}f{size}"), size)
        if cls == 3:
            return _Type(np.dtype(f"S{size}"), size)
        if cls == 9:
            if bits & 0x0F != 1:
                _refuse(f"{self.path}: variable-length sequence datatype")
            return _Type(np.dtype(object), size, vlen_str=True)
        _refuse(f"{self.path}: datatype class {cls} "
                f"({_DATATYPE_CLASSES.get(cls, 'unknown')})")

    def _dataspace(self, pos: int) -> tuple[int, ...] | None:
        ver, rank = self._mm[pos], self._mm[pos + 1]
        if ver == 1:
            dims = pos + 8
        elif ver == 2:
            if self._mm[pos + 3] == 2:       # null dataspace
                return None
            dims = pos + 4
        else:
            _refuse(f"{self.path}: dataspace message version {ver}")
        return tuple(self._len(dims + i * self.sl) for i in range(rank))

    def _gheap_object(self, addr: int, index: int) -> bytes:
        coll = self._gheaps.get(addr)
        if coll is None:
            if self._bytes(addr, 4) != b"GCOL":
                raise HDF5FormatError(
                    f"{self.path}: no global heap collection at {addr}")
            end = addr + self._len(addr + 8)
            pos = addr + 8 + self.sl
            coll = {}
            while pos + 8 + self.sl <= end:
                idx = struct.unpack_from("<H", self._mm, pos)[0]
                if idx == 0:                  # free space: the rest
                    break
                osize = self._len(pos + 8)
                coll[idx] = self._bytes(pos + 8 + self.sl, osize)
                pos += 8 + self.sl + _round8(osize)
            self._gheaps[addr] = coll
        try:
            return coll[index]
        except KeyError:
            raise HDF5FormatError(
                f"{self.path}: global heap object {index} missing from the "
                f"collection at {addr}") from None

    def _vlen_strings(self, raw: bytes, count: int, size: int) -> list:
        out = []
        for i in range(count):
            e = raw[i * size:(i + 1) * size]
            n = int.from_bytes(e[:4], "little")
            addr = int.from_bytes(e[4:4 + self.so], "little")
            index = int.from_bytes(e[4 + self.so:8 + self.so], "little")
            out.append(self._gheap_object(self._abs(addr), index)[:n]
                       if n else b"")
        return out

    def _values(self, t: _Type, shape: tuple | None, raw: bytes):
        """Element bytes of ``shape`` as the array (or, for a scalar, the
        numpy scalar) h5py returns; vlen strings as bytes."""
        if shape is None:
            return None
        count = math.prod(shape)
        if t.vlen_str:
            arr = np.empty(count, object)
            arr[:] = self._vlen_strings(raw, count, t.size)
            arr = arr.reshape(shape)
        else:
            arr = np.frombuffer(raw, t.dtype, count).reshape(shape).copy()
        return arr[()] if shape == () else arr

    def _attributes(self, msgs) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for mtype, _, pos, _ in msgs:
            if mtype == _ATTRIBUTE_INFO:
                _refuse(f"{self.path}: dense attribute storage (fractal "
                        f"heap)")
            if mtype != _ATTRIBUTE:
                continue
            ver, flags = self._mm[pos], self._mm[pos + 1]
            name_size, dt_size, ds_size = struct.unpack_from(
                "<HHH", self._mm, pos + 2)
            if ver not in (1, 2, 3):
                _refuse(f"{self.path}: attribute message version {ver}")
            if ver > 1 and flags & 0x03:
                _refuse(f"{self.path}: attribute with a shared datatype "
                        f"or dataspace")
            pad = _round8 if ver == 1 else (lambda n: n)
            p = pos + 8 + (1 if ver == 3 else 0)
            name = self._bytes(p, name_size).split(b"\0", 1)[0].decode(
                "utf-8")
            p += pad(name_size)
            t = self._datatype(p)
            p += pad(dt_size)
            shape = self._dataspace(p)
            p += pad(ds_size)
            n = 0 if shape is None else math.prod(shape) * t.size
            value = self._values(t, shape, self._bytes(p, n))
            if t.vlen_str:   # h5py hands vlen string attributes back as str
                value = (value.decode("utf-8") if isinstance(value, bytes)
                         else np.array([v.decode("utf-8") for v in
                                        value.reshape(-1)],
                                       object).reshape(value.shape))
            out[name] = value
        return out


class Group:
    """A symbol-table group: members by name (sorted, as the B-tree
    orders them), ``/``-separated paths, attributes."""

    def __init__(self, f: File, name: str, addr: int, msgs=None):
        self._file = f
        self.name = name
        self._addr = addr
        self._msgs = msgs
        self._members: dict[str, int] | None = None
        self._attrs: dict[str, Any] | None = None

    def _load(self) -> dict[str, int]:
        if self._members is None:
            if self._msgs is None:
                self._msgs = self._file._messages(self._addr)
            st = [m for m in self._msgs if m[0] == _SYMBOL_TABLE]
            if not st:
                _refuse(f"{self._file.path}: group {self.name!r} has no "
                        f"symbol table message")
            pos = st[0][2]
            f = self._file
            self._members = f._group_members(f._off(pos),
                                             f._abs(f._off(pos + f.so)))
        return self._members

    def __getitem__(self, path: str):
        node: Any = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group):
                raise KeyError(f"{path!r}: {node.name!r} is a dataset")
            members = node._load()
            if part not in members:
                raise KeyError(f"{part!r} is not in group {node.name!r} of "
                               f"{self._file.path}")
            child = node.name.rstrip("/") + "/" + part
            node = self._file._node(child, members[part])
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
            return True
        except KeyError:
            return False

    def keys(self) -> list[str]:
        return sorted(self._load(), key=lambda k: k.encode("utf-8"))

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._load())

    @property
    def attrs(self) -> dict[str, Any]:
        if self._attrs is None:
            if self._msgs is None:
                self._msgs = self._file._messages(self._addr)
            self._attrs = self._file._attributes(self._msgs)
        return self._attrs


class Dataset:
    """A dataset: ``shape``, ``dtype``, ``attrs``, and its values through
    ``ds[()]``, read on access."""

    def __init__(self, f: File, name: str, addr: int, msgs):
        self._file = f
        self.name = name
        self._msgs = msgs
        by = {}
        for mtype, _, pos, size in msgs:
            by.setdefault(mtype, (pos, size))
        if _DATATYPE not in by or _DATASPACE not in by:
            raise HDF5FormatError(f"{f.path}: dataset {name!r} lacks its "
                                  f"datatype or dataspace message")
        self._type = f._datatype(by[_DATATYPE][0])
        self.shape = f._dataspace(by[_DATASPACE][0])
        self.dtype = self._type.dtype
        self._layout = by[_LAYOUT][0]
        self._filters = (self._pipeline(by[_FILTERS_MSG][0])
                         if _FILTERS_MSG in by else [])
        self._fill = self._fill_value(by)
        self._attrs: dict[str, Any] | None = None

    @property
    def attrs(self) -> dict[str, Any]:
        if self._attrs is None:
            self._attrs = self._file._attributes(self._msgs)
        return self._attrs

    def _pipeline(self, pos: int) -> list[tuple[int, list[int]]]:
        f = self._file
        ver, n = f._mm[pos], f._mm[pos + 1]
        if ver not in (1, 2):
            _refuse(f"{f.path}: filter pipeline message version {ver}")
        p = pos + (8 if ver == 1 else 2)
        out = []
        for _ in range(n):
            fid = struct.unpack_from("<H", f._mm, p)[0]
            p += 2
            if ver == 1 or fid >= 256:
                name_len = struct.unpack_from("<H", f._mm, p)[0]
                p += 2
            else:
                name_len = 0
            _flags, nvals = struct.unpack_from("<HH", f._mm, p)
            p += 4
            p += _round8(name_len) if ver == 1 else name_len
            vals = list(struct.unpack_from(f"<{nvals}I", f._mm, p))
            p += 4 * nvals
            if ver == 1 and nvals % 2:
                p += 4
            if fid not in (1, 2, 3):
                _refuse(f"{f.path}: dataset {self.name!r}: filter {fid} "
                        f"({_FILTERS.get(fid, 'unregistered')})")
            out.append((fid, vals))
        return out

    def _fill_value(self, by) -> bytes | None:
        f = self._file
        raw = None
        if _FILL in by:
            pos = by[_FILL][0]
            ver = f._mm[pos]
            if ver in (1, 2):
                if ver == 1 or f._mm[pos + 3]:
                    n = struct.unpack_from("<I", f._mm, pos + 4)[0]
                    raw = f._bytes(pos + 8, n)
            elif ver == 3:
                if f._mm[pos + 1] & 0x20:
                    n = struct.unpack_from("<I", f._mm, pos + 2)[0]
                    raw = f._bytes(pos + 6, n)
            else:
                _refuse(f"{f.path}: fill value message version {ver}")
        elif _FILL_OLD in by:
            pos = by[_FILL_OLD][0]
            n = struct.unpack_from("<I", f._mm, pos)[0]
            raw = f._bytes(pos + 4, n)
        if raw is not None and len(raw) != self._type.size:
            raw = None
        return raw

    def _filled(self, shape) -> np.ndarray:
        t = self._type
        if t.vlen_str:
            out = np.empty(shape, object)
            out[...] = b""
            return out
        if self._fill is None:
            return np.zeros(shape, t.dtype)
        return np.full(shape, np.frombuffer(self._fill, t.dtype)[0],
                       t.dtype)

    def _decode_chunk(self, raw: bytes, mask: int, where: int) -> bytes:
        """Undo the pipeline (last filter first), skipping each filter
        whose bit is set in the chunk's mask."""
        for j in reversed(range(len(self._filters))):
            if mask & (1 << j):
                continue
            fid, vals = self._filters[j]
            if fid == 1:
                raw = zlib.decompress(raw)
            elif fid == 2:
                size = vals[0] if vals else self._type.size
                n = len(raw) // size
                if size > 1 and n > 1:
                    raw = (np.frombuffer(raw, np.uint8, n * size)
                           .reshape(size, n).T.tobytes() + raw[n * size:])
            else:
                body, stored = raw[:-4], int.from_bytes(raw[-4:], "little")
                got = fletcher32(body)
                swapped = ((got & 0x00FF00FF) << 8) | ((got >> 8)
                                                       & 0x00FF00FF)
                if stored not in (got, swapped):
                    raise HDF5FormatError(
                        f"{self._file.path}: dataset {self.name!r}: chunk "
                        f"at {where} fails its fletcher32 ({stored:#010x} "
                        f"!= {got:#010x})")
                raw = body
        return raw

    def _chunks(self, btree: int, ndims: int) -> Iterator[tuple]:
        """(offsets, size, filter mask, address) of every stored chunk."""
        f = self._file
        key = 8 + 8 * ndims

        def walk(node: int):
            if f._bytes(node, 4) != b"TREE" or f._mm[node + 4] != 1:
                raise HDF5FormatError(
                    f"{f.path}: no chunk B-tree node at {node}")
            level = f._mm[node + 5]
            used = struct.unpack_from("<H", f._mm, node + 6)[0]
            pos = node + 8 + 2 * f.so
            for _ in range(used):
                size, mask = struct.unpack_from("<II", f._mm, pos)
                offs = struct.unpack_from(f"<{ndims}Q", f._mm, pos + 8)
                child = f._abs(f._off(pos + key))
                pos += key + f.so
                if level:
                    yield from walk(child)
                else:
                    yield offs, size, mask, child

        yield from walk(btree)

    def read(self):
        """The whole dataset: an array of its file dtype (a numpy scalar
        for a scalar dataset, vlen strings as bytes), or None for a null
        dataspace."""
        f, t, shape = self._file, self._type, self.shape
        if shape is None:
            return None
        pos = self._layout
        ver, cls = f._mm[pos], f._mm[pos + 1]
        if ver != 3:
            _refuse(f"{f.path}: dataset {self.name!r}: data layout message "
                    f"version {ver}")
        nbytes = math.prod(shape) * t.size
        if cls == 0:                                     # compact
            size = struct.unpack_from("<H", f._mm, pos + 2)[0]
            return f._values(t, shape, f._bytes(pos + 4, min(size, nbytes)))
        if cls == 1:                                     # contiguous
            addr = f._off(pos + 2)
            if not f._defined(addr) or nbytes == 0:
                out = self._filled(shape)
                return out[()] if shape == () else out
            addr = f._abs(addr)
            if not t.vlen_str:
                if addr + nbytes > f._size:
                    raise HDF5FormatError(
                        f"{f.path}: dataset {self.name!r} runs past the "
                        f"end of the file")
                arr = np.frombuffer(f._mm, t.dtype, math.prod(shape),
                                    addr).reshape(shape).copy()
                return arr[()] if shape == () else arr
            return f._values(t, shape, f._bytes(addr, nbytes))
        if cls == 2:                                     # chunked
            ndims = f._mm[pos + 2]
            btree = f._off(pos + 3)
            dims = struct.unpack_from(f"<{ndims}I", f._mm, pos + 3 + f.so)
            chunk = dims[:-1]
            out = self._filled(shape)
            if not f._defined(btree) or nbytes == 0:
                return out
            cells = math.prod(chunk)
            for offs, size, mask, addr in self._chunks(f._abs(btree),
                                                       ndims):
                raw = self._decode_chunk(f._bytes(addr, size), mask, addr)
                if len(raw) < cells * t.size:
                    raise HDF5FormatError(
                        f"{f.path}: dataset {self.name!r}: chunk at {addr} "
                        f"holds {len(raw)} bytes, {cells * t.size} wanted")
                block = f._values(t, tuple(chunk), raw[:cells * t.size])
                dst = tuple(slice(o, min(o + c, s))
                            for o, c, s in zip(offs, chunk, shape))
                out[dst] = block[tuple(slice(0, d.stop - d.start)
                                       for d in dst)]
            return out
        _refuse(f"{f.path}: dataset {self.name!r}: layout class {cls}")

    def __getitem__(self, key):
        return self.read() if key == () else self.read()[key]


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

_SO = _SL = 8
_UNDEF = (1 << 64) - 1
_ENTRY = 2 * _SO + 24          # a symbol table entry
_INTERNAL_K = 16


def _datatype_message(dtype: np.dtype, strlen: int | None) -> bytes:
    """A version-1 datatype message for a fixed-point or IEEE number of
    either byte order, or a null-terminated ASCII string of ``strlen``
    bytes."""
    if strlen is not None:
        return struct.pack("<BBBBI", 0x13, 0, 0, 0, strlen)
    size = dtype.itemsize
    order = 1 if dtype.byteorder == ">" else 0
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        signed = 0x08 if dtype.kind == "i" else 0
        return struct.pack("<BBBBIHH", 0x10, order | signed, 0, 0, size, 0,
                           8 * size)
    if dtype.kind == "f" and size in _IEEE:
        eloc, esize, mloc, msize, bias = _IEEE[size]
        # bits 4-5 = 2: the mantissa's leading one implied; byte 1 is the
        # sign bit's position
        return struct.pack("<BBBBIHHBBBBI", 0x11, order | 0x20,
                           8 * size - 1, 0, size, 0, 8 * size, eloc, esize,
                           mloc, msize, bias)
    raise ValueError(f"HDF5 writer: no datatype for numpy {dtype} "
                     f"(fixed-point and IEEE numbers, and strings only)")


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body.ljust(_round8(len(body)), b"\0")
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class _Writer:
    def __init__(self, leaf_k: int):
        self.leaf_k = leaf_k
        self.meta = bytearray()
        self.data: list[tuple[int, np.ndarray]] = []  # (patch at, array)

    def alloc(self, n: int) -> int:
        at = len(self.meta)
        self.meta += bytes(_round8(n))
        return at

    def put(self, at: int, raw: bytes) -> None:
        self.meta[at:at + len(raw)] = raw

    def group(self, members: Mapping[str, Any], where: str
              ) -> tuple[int, int, int]:
        """Write one group and its members: returns the addresses of its
        object header, B-tree and local heap."""
        names = sorted(members, key=lambda k: k.encode("utf-8"))
        for n in names:
            if not n or "/" in n or "\0" in n:
                raise ValueError(f"HDF5 writer: bad member name {n!r} in "
                                 f"{where}")
        # the local heap: "" at 0, then each name null-terminated and
        # padded to 8
        heap_data = bytearray(8)
        name_off = {}
        for n in names:
            name_off[n] = len(heap_data)
            raw = n.encode("utf-8") + b"\0"
            heap_data += raw.ljust(_round8(len(raw)), b"\0")
        ohdr = self.alloc(16 + 8 + 16)
        heap = self.alloc(32)
        heap_seg = self.alloc(len(heap_data))
        btree = self.alloc(8 + 2 * _SO + 2 * _INTERNAL_K * _SO
                           + (2 * _INTERNAL_K + 1) * _SL)
        snod = self.alloc(8 + 2 * self.leaf_k * _ENTRY)
        self.put(ohdr, _object_header([_message(
            _SYMBOL_TABLE, struct.pack("<QQ", btree, heap))]))
        # free-list head 1: no free block
        self.put(heap, b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data),
                                             1, heap_seg))
        self.put(heap_seg, bytes(heap_data))
        # one SNOD under one B-tree node: key 0 the empty name, key 1 the
        # largest name in the node
        last = name_off[names[-1]] if names else 0
        self.put(btree, b"TREE" + struct.pack("<BBHQQQQQ", 0, 0, 1, _UNDEF,
                                              _UNDEF, 0, snod, last))
        entries = bytearray()
        for n in names:
            value = members[n]
            if isinstance(value, Mapping):
                child, cbtree, cheap = self.group(value, f"{where}{n}/")
                scratch = struct.pack("<QQ", cbtree, cheap)
                cache = 1
            else:
                child, scratch, cache = self.dataset(value, where + n), \
                    bytes(16), 0
            entries += struct.pack("<QQI4x", name_off[n], child, cache) + \
                scratch
        self.put(snod, b"SNOD" + struct.pack("<BBH", 1, 0, len(names))
                 + bytes(entries))
        return ohdr, btree, heap

    def dataset(self, value: Any, where: str) -> int:
        strlen = None
        if isinstance(value, (str, bytes)):
            raw = value.encode("utf-8") if isinstance(value, str) else value
            strlen = len(raw) + 1
            arr = np.frombuffer(raw + b"\0", np.uint8)
            dims: tuple[int, ...] = ()
        else:
            arr = np.asarray(value)
            if arr.dtype.byteorder == "=" or arr.dtype.byteorder == "|":
                arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
            dims = arr.shape
        dtype_msg = _datatype_message(arr.dtype, strlen)
        space = struct.pack(f"<BBBx4x{len(dims)}Q", 1, len(dims), 0, *dims)
        # fill value v2: allocation early, fill written never, undefined
        fill = struct.pack("<BBBB", 2, 1, 1, 0)
        nbytes = arr.nbytes
        layout = struct.pack("<BBQQ", 3, 1, _UNDEF, nbytes)
        msgs = [_message(_DATASPACE, space), _message(_DATATYPE, dtype_msg, 1),
                _message(_FILL, fill, 1), _message(_LAYOUT, layout)]
        ohdr = self.alloc(16 + sum(len(m) for m in msgs))
        self.put(ohdr, _object_header(msgs))
        if nbytes:
            # the layout message's address: patched once data is placed
            at = ohdr + 16 + sum(len(m) for m in msgs[:3]) + 8 + 2
            self.data.append((at, arr))
        return ohdr


def _largest_group(tree: Mapping[str, Any]) -> int:
    most = len(tree)
    for v in tree.values():
        if isinstance(v, Mapping):
            most = max(most, _largest_group(v))
    return most


def write(path: str, tree: Mapping[str, Any]) -> None:
    """Write ``tree`` as an HDF5 file: a mapping is a group, a ``str`` or
    ``bytes`` value a scalar fixed-length string, anything else an array
    (or numpy scalar) of a fixed-point or IEEE type, as a contiguous
    dataset.  The file is written to a temporary name and renamed into
    place."""
    leaf_k = max(4, (_largest_group(tree) + 1) // 2)
    w = _Writer(leaf_k)
    w.alloc(24 + 4 * _SO + _ENTRY)                 # superblock v0
    root, rbtree, rheap = w.group(tree, "/")
    at = _round8(len(w.meta))
    places = []
    for patch, arr in w.data:
        places.append(at)
        w.put(patch, struct.pack("<Q", at))
        at = _round8(at + arr.nbytes)
    eof = at
    w.put(0, SIGNATURE + struct.pack(
        "<BBBBBBBBHHI", 0, 0, 0, 0, 0, _SO, _SL, 0, leaf_k, _INTERNAL_K, 0)
        + struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
        + struct.pack("<QQI4xQQ", 0, root, 1, rbtree, rheap))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(w.meta)
        pos = len(w.meta)
        for place, (_, arr) in zip(places, w.data):
            f.write(bytes(place - pos))
            f.write(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
                    .data)
            pos = place + arr.nbytes
        f.write(bytes(eof - pos))
    os.replace(tmp, path)

"""Pure-Python read-only LMDB parser (the port's own copy of
spgan_tpu/data/lmdb_read.py; standard library only).

The reference prepares its Matterport3D dataset as an LMDB
(prepare_data.py:100-175) and reads it with the `lmdb` C extension under
keys ``f"{resolution}-{idx:08d}"`` plus a ``length`` key
(dataset.py:388-610, key layout :576).  Neither the `lmdb` module nor
liblmdb is needed here: this module parses the on-disk format (data.mdb)
directly from the published file layout, enough for the ``source: lmdb``
data pipeline to read a reference-prepared LMDB.

Format facts implemented here (liblmdb 0.9.x, MDB_DATA_VERSION=1,
64-bit build):

  * file = array of `psize` pages; pages 0 and 1 are meta pages, the
    live one is the valid meta with the larger transaction id
  * page header (16 bytes): pgno u64 | pad u16 | flags u16 |
    lower u16 | upper u16 — for overflow pages the (lower, upper) slot
    is instead a u32 page count
  * node pointer array of u16 page-start offsets begins at byte 16;
    node count = (lower - 16) / 2; nodes are sorted ascending by key
  * node header (8 bytes): lo u16 | hi u16 | flags u16 | ksize u16,
    then the key bytes, then the data
      - branch node: child pgno = lo | hi<<16 | flags<<32 (node 0's key
        is the "everything below" sentinel and may be empty)
      - leaf node: data size = lo | hi<<16; flag F_BIGDATA means the
        data is a u64 pgno of an overflow chain (value bytes start at
        byte 16 of the first overflow page and run contiguously across
        the chain)
  * meta (at byte 16 of a meta page): magic u32 = 0xBEEFC0DE |
    version u32 | address u64 | mapsize u64 | MDB_db[2] | last_pg u64 |
    txnid u64; MDB_db (48 bytes) = pad u32 | flags u16 | depth u16 |
    branch_pages u64 | leaf_pages u64 | overflow_pages u64 |
    entries u64 | root u64.  dbs[0] is the free DB (its `pad` holds the
    page size); dbs[1] is the main DB.

Unsupported (loudly): MDB_DUPSORT values (F_DUPDATA / dup subpages),
MDB_DUPFIXED leaves (P_LEAF2), named sub-databases (F_SUBDATA) — the
reference uses none of them (plain puts into the main DB).

The API mirrors the subset of the `lmdb` python binding the tools use:
``open(path, ...)`` -> Env with ``.begin(write=False)`` -> Txn with
``.get(key)`` and ``.cursor()`` (iterating sorted (key, value) pairs).
"""
from __future__ import annotations

import io
import mmap
import os
import struct
from bisect import bisect_right
from typing import Iterator, Optional, Tuple

_MAGIC = 0xBEEFC0DE
_VERSION = 1
_PAGEHDRSZ = 16
_P_INVALID = 0xFFFFFFFFFFFFFFFF

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

_META = struct.Struct("<IIQQ")          # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")        # pad, flags, depth, branch, leaf,
#                                         overflow, entries, root
_PGHDR = struct.Struct("<QHHHH")        # pgno, pad, flags, lower, upper
_NODE = struct.Struct("<HHHH")          # lo, hi, flags, ksize


class LmdbFormatError(ValueError):
    pass


class _MainDb:
    __slots__ = ("flags", "depth", "branch_pages", "leaf_pages",
                 "overflow_pages", "entries", "root")

    def __init__(self, raw: bytes):
        (_pad, self.flags, self.depth, self.branch_pages, self.leaf_pages,
         self.overflow_pages, self.entries, self.root) = _DB.unpack(raw)


class Environment:
    """Read-only LMDB environment over a mmap of data.mdb."""

    def __init__(self, path: str, subdir: bool = True):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self.path = path
        self._f = io.open(path, "rb")  # io.open: the module defines open()
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._load_meta()

    # -- meta ------------------------------------------------------------
    def _read_meta(self, off: int):
        m = self._mm
        _, _, flags, _, _ = _PGHDR.unpack_from(m, off)
        magic, version, _addr, _mapsize = _META.unpack_from(
            m, off + _PAGEHDRSZ)
        if not flags & P_META or magic != _MAGIC:
            raise LmdbFormatError(
                f"{self.path}: no LMDB meta page at offset {off} "
                f"(magic {magic:#x}, page flags {flags:#x})")
        if version != _VERSION:
            raise LmdbFormatError(
                f"{self.path}: unsupported LMDB data version {version} "
                f"(expected {_VERSION})")
        base = off + _PAGEHDRSZ + _META.size
        psize = struct.unpack_from("<I", m, base)[0]  # dbs[0].md_pad
        main = _MainDb(m[base + _DB.size:base + 2 * _DB.size])
        last_pg, txnid = struct.unpack_from("<QQ", m, base + 2 * _DB.size)
        return psize, main, last_pg, txnid

    def _load_meta(self):
        psize0, main0, _, txn0 = self._read_meta(0)
        try:
            psize1, main1, _, txn1 = self._read_meta(psize0)
        except (LmdbFormatError, struct.error):
            psize1, main1, txn1 = psize0, main0, -1
        if txn1 > txn0:
            self.psize, self.main, self.txnid = psize1, main1, txn1
        else:
            self.psize, self.main, self.txnid = psize0, main0, txn0

    # -- page access -----------------------------------------------------
    def _page(self, pgno: int) -> int:
        off = pgno * self.psize
        if off + self.psize > len(self._mm):
            raise LmdbFormatError(f"page {pgno} beyond end of file")
        return off

    def _nodes(self, off: int):
        """(flags, [(key, node_flags, lo_hi, data_off)]) of the page at off."""
        m = self._mm
        _, _, flags, lower, _ = _PGHDR.unpack_from(m, off)
        if flags & P_LEAF2:
            raise LmdbFormatError("MDB_DUPFIXED (P_LEAF2) pages are not "
                                  "supported (not used by the reference)")
        n = (lower - _PAGEHDRSZ) >> 1
        out = []
        for i in range(n):
            p = struct.unpack_from("<H", m, off + _PAGEHDRSZ + 2 * i)[0]
            lo, hi, nflags, ksize = _NODE.unpack_from(m, off + p)
            kst = off + p + _NODE.size
            out.append((bytes(m[kst:kst + ksize]), nflags, lo | (hi << 16),
                        kst + ksize))
        return flags, out

    def _leaf_value(self, nflags: int, dsize: int, doff: int) -> bytes:
        m = self._mm
        if nflags & (F_SUBDATA | F_DUPDATA):
            raise LmdbFormatError(
                "named sub-database / DUPSORT values are not supported "
                "(the reference stores plain values in the main DB)")
        if nflags & F_BIGDATA:
            ovpg = struct.unpack_from("<Q", m, doff)[0]
            ovoff = self._page(ovpg)
            _, _, ovflags, pages = struct.unpack_from("<QHHI", m, ovoff)
            if not ovflags & P_OVERFLOW:
                raise LmdbFormatError(
                    f"overflow chain at page {ovpg} lacks P_OVERFLOW")
            if ovoff + pages * self.psize > len(self._mm):
                raise LmdbFormatError("overflow chain beyond end of file")
            st = ovoff + _PAGEHDRSZ
            return bytes(m[st:st + dsize])
        return bytes(m[doff:doff + dsize])

    # -- tree ------------------------------------------------------------
    def _get(self, key: bytes) -> Optional[bytes]:
        if self.main.root == _P_INVALID:
            return None
        pgno = self.main.root
        for _ in range(self.main.depth + 1):
            off = self._page(pgno)
            flags, nodes = self._nodes(off)
            if flags & P_LEAF:
                keys = [k for k, _, _, _ in nodes]
                i = bisect_right(keys, key) - 1
                if i >= 0 and keys[i] == key:
                    _, nflags, dsize, doff = nodes[i]
                    return self._leaf_value(nflags, dsize, doff)
                return None
            if not flags & P_BRANCH:
                raise LmdbFormatError(f"page {pgno}: unexpected flags "
                                      f"{flags:#x} inside the tree")
            # branch: rightmost child whose separator <= key; node 0's
            # separator is the -inf sentinel
            keys = [k for k, _, _, _ in nodes[1:]]
            i = bisect_right(keys, key)
            pgno = nodes[i][2] | (nodes[i][1] << 32)
        raise LmdbFormatError("tree deeper than the meta's depth field")

    def _iter_leaves(self, pgno: int,
                     values: bool = True) -> Iterator[Tuple[bytes, bytes]]:
        off = self._page(pgno)
        flags, nodes = self._nodes(off)
        if flags & P_LEAF:
            for key, nflags, dsize, doff in nodes:
                # values=False skips value materialization entirely — a
                # keys-only walk of a multi-GB LMDB must not reassemble
                # every overflow chain just to enumerate keys
                yield key, (self._leaf_value(nflags, dsize, doff)
                            if values else None)
        elif flags & P_BRANCH:
            for _, nflags, lohi, _ in nodes:
                yield from self._iter_leaves(lohi | (nflags << 32),
                                             values=values)
        else:
            raise LmdbFormatError(f"page {pgno}: unexpected flags "
                                  f"{flags:#x} inside the tree")

    # -- lmdb-binding-shaped surface --------------------------------------
    def begin(self, write: bool = False, **_ignored) -> "Transaction":
        if write:
            raise LmdbFormatError("this parser is read-only")
        return Transaction(self)

    def stat(self) -> dict:
        m = self.main
        return {"psize": self.psize, "depth": m.depth,
                "branch_pages": m.branch_pages, "leaf_pages": m.leaf_pages,
                "overflow_pages": m.overflow_pages, "entries": m.entries}

    def close(self):
        if self._mm is not None:
            self._mm.close()
            self._f.close()
            self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Transaction:
    def __init__(self, env: Environment):
        self.env = env

    def get(self, key: bytes, default=None):
        v = self.env._get(bytes(key))
        return default if v is None else v

    def cursor(self) -> "Cursor":
        return Cursor(self.env)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class Cursor:
    """Sorted iteration over all (key, value) pairs of the main DB."""

    def __init__(self, env: Environment):
        self.env = env

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        if self.env.main.root == _P_INVALID:
            return
        yield from self.env._iter_leaves(self.env.main.root)

    def iternext(self, keys: bool = True, values: bool = True):
        if self.env.main.root == _P_INVALID:
            return
        it = self.env._iter_leaves(self.env.main.root, values=values)
        for k, v in it:
            if keys and values:
                yield k, v
            elif keys:
                yield k
            else:
                yield v


def open(path: str, readonly: bool = True, subdir: bool = True,
         **_ignored) -> Environment:
    """`lmdb.open`-shaped constructor (read-only subset; extra kwargs like
    lock/readahead/meminit are accepted and ignored)."""
    if not readonly:
        raise LmdbFormatError("this parser is read-only")
    return Environment(path, subdir=subdir)

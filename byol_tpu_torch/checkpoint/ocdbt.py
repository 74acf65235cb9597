"""A reader of OCDBT, the key-value store orbax checkpoints live in
(tensorstore's "optionally-cooperative distributed B+tree"), without
tensorstore.

A store is a directory with ``manifest.ocdbt`` at its root.  The manifest
and every node are an envelope: a 4-byte big-endian magic
(``0cdb3a2a`` manifest, ``0cdb20de`` B+tree node, ``0cdb1234`` version
tree node), the file's length as a little-endian u64, a varint format
version (0) and a varint compression (0 none, 1 zstd), the body (a zstd
frame under compression 1), and a CRC-32C of every byte before it,
little-endian.  Bodies are varints, bytes and little-endian integers,
laid out column by column:

- a data-file table (count; the length each path shares with the one
  before; each path's remaining length; each path's base-path length;
  the remaining bytes): a path is ``base_path + relative_path`` under the
  store's root, such as ``ocdbt.process_0/d/<hash>``;
- the manifest: the config (uuid, manifest kind, max inline value bytes,
  max decoded node bytes, version-tree arity log2, compression and its
  zstd level), a data-file table, the inline version-tree leaf (each
  version's generation, root height, root location, statistics, commit
  time) and the out-of-line version-tree nodes it refers to;
- a B+tree node: its height, a data-file table, the entries' keys
  (prefix-compressed against the previous key, relative to the prefix
  the parent entries gave), then for a leaf each value's length and
  kind (0 inline, 1 indirect), the indirect values' file and offset, and
  the inline bytes; for an interior node each child's subtree common
  prefix length, location and statistics.

:class:`OcdbtStore` reads the newest version: :meth:`keys`,
:meth:`read` and :meth:`read_many` (each data file opened once).
Everything is verified (magic, length, CRC-32C, node heights, bounds);
anything else raises ``ValueError`` naming the file and offset.
"""
from __future__ import annotations

import dataclasses
import os
import struct
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

from byol_tpu_torch.checkpoint import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_MAGIC = 0x0CDB1234
_HEADER = 12                       # magic + length
_FOOTER = 4                        # CRC-32C
_MISSING = (1 << 64) - 1           # the offset of a missing reference


@dataclasses.dataclass(frozen=True)
class DataFile:
    base_path: str
    relative_path: str

    @property
    def path(self) -> str:
        return self.base_path + self.relative_path


@dataclasses.dataclass(frozen=True)
class Ref:
    """A byte range of a data file (a node or an out-of-line value)."""
    file: DataFile
    offset: int
    length: int

    @property
    def missing(self) -> bool:
        """The empty tree's root: no file, offset and length all ones."""
        return not self.file.path and self.offset == _MISSING


@dataclasses.dataclass(frozen=True)
class Statistics:
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int


@dataclasses.dataclass(frozen=True)
class Version:
    generation_number: int
    root_height: int
    root: Ref
    statistics: Statistics
    commit_time: int


@dataclasses.dataclass(frozen=True)
class VersionNodeRef:
    generation_number: int
    location: Ref
    num_generations: int
    commit_time: int
    height: int


@dataclasses.dataclass(frozen=True)
class Config:
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: Optional[str]
    zstd_level: Optional[int]


@dataclasses.dataclass(frozen=True)
class Manifest:
    config: Config
    versions: Tuple[Version, ...]
    version_tree_nodes: Tuple[VersionNodeRef, ...]


@dataclasses.dataclass(frozen=True)
class LeafEntry:
    key: bytes                     # relative to the node's prefix
    value: Any                     # bytes (inline) or Ref (indirect)


@dataclasses.dataclass(frozen=True)
class InteriorEntry:
    key: bytes                     # relative to the node's prefix
    subtree_common_prefix_length: int
    location: Ref
    statistics: Statistics


@dataclasses.dataclass(frozen=True)
class BtreeNode:
    height: int
    entries: Tuple[Any, ...]       # LeafEntry at height 0, else InteriorEntry


@dataclasses.dataclass(frozen=True)
class VersionNode:
    version_tree_arity_log2: int
    height: int
    entries: Tuple[Any, ...]       # Version at height 0, else VersionNodeRef


class _Reader:
    def __init__(self, data: bytes, what: str) -> None:
        self.data, self.pos, self.what = data, 0, what

    def fail(self, msg: str) -> None:
        raise ValueError(f"ocdbt: {self.what}: {msg} (at body offset "
                         f"{self.pos})")

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            self.fail(f"truncated: {n} bytes wanted")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            if shift > 63:
                self.fail("varint longer than 64 bits")
            b = self.u8()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def column(self, n: int, read=None) -> List[int]:
        return [(read or self.varint)() for _ in range(n)]

    def count(self, limit: int = 1 << 24) -> int:
        n = self.varint()
        if n > limit or n > len(self.data):
            self.fail(f"count {n} larger than the body")
        return n

    def end(self) -> None:
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes left over")


def decode_envelope(data: bytes, magic: int, what: str,
                    max_decoded: Optional[int] = None) -> bytes:
    """The verified, decompressed body of a manifest or node."""
    if len(data) < _HEADER + 2 + _FOOTER:
        raise ValueError(f"ocdbt: {what}: {len(data)} bytes is too short")
    got_magic, length = struct.unpack(">I", data[:4])[0], \
        struct.unpack("<Q", data[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"ocdbt: {what}: magic {got_magic:08x}, expected "
                         f"{magic:08x}")
    if length != len(data):
        raise ValueError(f"ocdbt: {what}: header says {length} bytes, the "
                         f"file holds {len(data)}")
    want = struct.unpack("<I", data[-_FOOTER:])[0]
    got = zstd.crc32c(memoryview(data)[:-_FOOTER])
    if got != want:
        raise ValueError(f"ocdbt: {what}: CRC-32C {got:08x} != the footer's "
                         f"{want:08x}")
    r = _Reader(data[:-_FOOTER], what)
    r.pos = _HEADER
    version = r.varint()
    if version != 0:
        r.fail(f"format version {version}; this reader knows 0")
    compression = r.varint()
    body = data[r.pos:-_FOOTER]
    if compression == 0:
        return body
    if compression != 1:
        r.fail(f"compression {compression}; this reader knows 0 and 1")
    size = zstd.content_size(body)
    if max_decoded is not None and size is not None and size > max_decoded:
        r.fail(f"decoded node of {size} bytes exceeds the store's "
               f"max_decoded_node_bytes {max_decoded}")
    return zstd.decompress(body)


def _data_file_table(r: _Reader) -> List[DataFile]:
    n = r.count()
    prefix = [0] + r.column(n - 1) if n else []
    suffix = r.column(n)
    base = r.column(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail(f"data file {i} shares {prefix[i]} bytes of a "
                   f"{len(prev)}-byte path")
        path = prev[:prefix[i]] + r.take(suffix[i])
        if base[i] > len(path):
            r.fail(f"data file {i}'s base path is longer than its path")
        try:
            files.append(DataFile(path[:base[i]].decode(),
                                  path[base[i]:].decode()))
        except UnicodeDecodeError:
            r.fail(f"data file {i}'s path is not UTF-8")
        prev = path
    return files


def _refs(r: _Reader, files: List[DataFile], n: int,
          lengths: Optional[List[int]] = None) -> List[Ref]:
    ids = r.column(n)
    offsets = r.column(n)
    if lengths is None:
        lengths = r.column(n)
    out = []
    for i, offset, length in zip(ids, offsets, lengths):
        if i >= len(files):
            r.fail(f"data file index {i} of a {len(files)}-file table")
        out.append(Ref(files[i], offset, length))
    return out


def _statistics(r: _Reader, n: int) -> List[Statistics]:
    keys, tree, indirect = r.column(n), r.column(n), r.column(n)
    return [Statistics(*s) for s in zip(keys, tree, indirect)]


def _version_leaf(r: _Reader, files: List[DataFile]) -> List[Version]:
    n = r.count()
    gens = r.column(n)
    heights = r.column(n, r.u8)
    roots = _refs(r, files, n)
    stats = _statistics(r, n)
    times = r.column(n, r.u64)
    return [Version(*v) for v in zip(gens, heights, roots, stats, times)]


def _version_interior(r: _Reader, files: List[DataFile],
                      heights: Optional[int] = None) -> List[VersionNodeRef]:
    """Entries of an interior version-tree node; ``heights`` is the
    children's height when the node implies it (else a column of them,
    as in the manifest)."""
    n = r.count()
    gens = r.column(n)
    locs = _refs(r, files, n)
    num = r.column(n)
    times = r.column(n, r.u64)
    hs = r.column(n, r.u8) if heights is None else [heights] * n
    return [VersionNodeRef(*v) for v in zip(gens, locs, num, times, hs)]


def decode_manifest(data: bytes) -> Manifest:
    r = _Reader(decode_envelope(data, MANIFEST_MAGIC, "manifest"),
                "manifest")
    uuid = r.take(16)
    kind = r.varint()
    inline, node_bytes = r.varint(), r.varint()
    arity = r.u8()
    comp = r.varint()
    if comp == 0:
        compression, level = None, None
    elif comp == 1:
        compression, level = "zstd", r.i32()
    else:
        r.fail(f"config compression {comp}")
    config = Config(uuid, kind, inline, node_bytes, arity, compression, level)
    if kind != 0:
        raise ValueError("ocdbt: a numbered manifest (kind 1) is not read "
                         "here; orbax writes a single manifest")
    files = _data_file_table(r)
    versions = _version_leaf(r, files)
    nodes = _version_interior(r, files)
    r.end()
    if not versions:
        raise ValueError("ocdbt: the manifest holds no version")
    return Manifest(config, tuple(versions), tuple(nodes))


def decode_version_node(data: bytes, what: str = "version node"
                        ) -> VersionNode:
    r = _Reader(decode_envelope(data, VERSION_MAGIC, what), what)
    arity, height = r.u8(), r.u8()
    files = _data_file_table(r)
    entries = (_version_leaf(r, files) if height == 0
               else _version_interior(r, files, heights=height - 1))
    r.end()
    return VersionNode(arity, height, tuple(entries))


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes],
                                                        List[int]]:
    shared = [0] + r.column(n - 1) if n else []
    suffix = r.column(n)
    common = r.column(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            r.fail(f"key {i} shares {shared[i]} bytes of a {len(prev)}-byte "
                   "key")
        prev = prev[:shared[i]] + r.take(suffix[i])
        keys.append(prev)
    for i, c in enumerate(common):
        if c > len(keys[i]):
            r.fail(f"entry {i}'s subtree common prefix is longer than its "
                   "key")
    return keys, common


def decode_btree_node(data: bytes, what: str = "btree node",
                      max_decoded: Optional[int] = None) -> BtreeNode:
    r = _Reader(decode_envelope(data, BTREE_MAGIC, what, max_decoded), what)
    height = r.u8()
    files = _data_file_table(r)
    n = r.count()
    keys, common = _keys(r, n, height > 0)
    if height == 0:
        lengths = r.column(n)
        kinds = r.column(n)
        if any(k > 1 for k in kinds):
            r.fail(f"value kinds {sorted(set(kinds))}; 0 inline, 1 indirect")
        indirect = [i for i, k in enumerate(kinds) if k == 1]
        refs = _refs(r, files, len(indirect), [lengths[i] for i in indirect])
        values: List[Any] = [None] * n
        for i, ref in zip(indirect, refs):
            values[i] = ref
        for i, k in enumerate(kinds):
            if k == 0:
                values[i] = r.take(lengths[i])
        entries: List[Any] = [LeafEntry(k, v) for k, v in zip(keys, values)]
    else:
        locs = _refs(r, files, n)
        stats = _statistics(r, n)
        entries = [InteriorEntry(*e) for e in zip(keys, common, locs, stats)]
    r.end()
    return BtreeNode(height, tuple(entries))


class OcdbtStore:
    """The newest version of the OCDBT store under ``root``."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        path = os.path.join(self.root, "manifest.ocdbt")
        with open(path, "rb") as f:
            self.manifest = decode_manifest(f.read())
        self.version = self.manifest.versions[-1]
        self._entries: Optional[Dict[bytes, Any]] = None
        self.bytes_read = 0            # value bytes read so far

    # -- raw access ----------------------------------------------------
    def _file(self, file: DataFile) -> str:
        path = os.path.normpath(os.path.join(self.root, file.path))
        if not path.startswith(self.root + os.sep):
            raise ValueError(f"ocdbt: data file {file.path!r} lies outside "
                             f"the store {self.root}")
        return path

    def read_ref(self, ref: Ref) -> bytes:
        with open(self._file(ref.file), "rb") as f:
            return self._pread(f, ref)

    @staticmethod
    def _pread(f, ref: Ref) -> bytes:
        f.seek(ref.offset)
        data = f.read(ref.length)
        if len(data) != ref.length:
            raise ValueError(f"ocdbt: {ref.file.path} holds no "
                             f"{ref.length} bytes at {ref.offset}")
        return data

    def node(self, ref: Ref) -> BtreeNode:
        what = f"btree node {ref.file.path}@{ref.offset}"
        return decode_btree_node(
            self.read_ref(ref), what,
            self.manifest.config.max_decoded_node_bytes)

    def version_node(self, ref: Ref) -> VersionNode:
        return decode_version_node(
            self.read_ref(ref), f"version node {ref.file.path}@{ref.offset}")

    # -- the key space ---------------------------------------------------
    def _walk(self, ref: Ref, height: int, prefix: bytes,
              out: Dict[bytes, Any]) -> None:
        node = self.node(ref)
        if node.height != height:
            raise ValueError(f"ocdbt: node {ref.file.path}@{ref.offset} has "
                             f"height {node.height}, its parent says "
                             f"{height}")
        for e in node.entries:
            if height == 0:
                out[prefix + e.key] = e.value
            else:
                self._walk(e.location, height - 1,
                           prefix + e.key[:e.subtree_common_prefix_length],
                           out)

    def entries(self) -> Dict[bytes, Any]:
        """{key: bytes (inline) or Ref (out of line)} of every key."""
        if self._entries is None:
            out: Dict[bytes, Any] = {}
            if not self.version.root.missing:
                self._walk(self.version.root, self.version.root_height, b"",
                           out)
            self._entries = dict(sorted(out.items()))
        return self._entries

    def keys(self) -> List[bytes]:
        return list(self.entries())

    def read(self, key: bytes) -> bytes:
        value = self.entries()[key]       # KeyError on a missing key
        if isinstance(value, Ref):
            value = self.read_ref(value)
        self.bytes_read += len(value)
        return value

    def iter_many(self, keys: Iterable[bytes]) -> Iterator[Tuple[bytes,
                                                                 bytes]]:
        """``(key, value)`` of each key, inline values first, then each
        data file's values in offset order, every file opened once."""
        entries = self.entries()
        by_file: Dict[str, List[Tuple[Ref, bytes]]] = {}
        for key in keys:
            value = entries[key]
            if isinstance(value, Ref):
                by_file.setdefault(value.file.path, []).append((value, key))
            else:
                self.bytes_read += len(value)
                yield key, value
        for items in by_file.values():
            items.sort(key=lambda item: item[0].offset)
            with open(self._file(items[0][0].file), "rb") as f:
                for ref, key in items:
                    data = self._pread(f, ref)
                    self.bytes_read += len(data)
                    yield key, data

    def read_many(self, keys: Iterable[bytes]) -> Dict[bytes, bytes]:
        return dict(self.iter_many(keys))

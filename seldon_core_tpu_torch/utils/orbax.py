"""Reader of the checkpoints ``orbax.checkpoint.StandardCheckpointer`` writes.

The JAX server restores a checkpoint directory that holds
``_CHECKPOINT_METADATA`` with ``orbax.checkpoint`` (``models/jaxserver.py``);
the port reads the same files without orbax, tensorstore or zarr:

* ``_METADATA`` (JSON) lists the tree: each leaf's key path
  (``key_metadata``: dict keys and sequence indices) and value type, and
  whether the arrays sit in one OCDBT store (``use_ocdbt``) and in zarr v2
  or v3 (``use_zarr3``; v3 is refused by name);
* the OCDBT store (tensorstore's key-value B-tree): the root
  ``manifest.ocdbt`` names the newest version's root node; each node is a
  file range under ``d/`` (or under ``ocdbt.process_N/d/``, where orbax's
  per-process stores wrote it), holding keys and their values, inline or
  as a range of another data file.  Manifests and nodes are checked
  against their CRC-32C and decompressed with zstd;
* each leaf is a zarr v2 array under ``<param name>/``: ``.zarray``
  (shape, chunks, dtype, compressor, fill value) and one value per chunk
  (``0.1`` keys, ``0`` for a 0-d array).  Edge chunks are padded to the
  full chunk shape; a missing chunk is the fill value.  Chunks are zstd
  frames (orbax's ``{"id": "zstd"}``) or raw; any other compressor,
  filters or Fortran order is refused by name;
* zstd is the system's ``libzstd.so.1`` through ``ctypes``
  (``ZSTD_getFrameContentSize`` / ``ZSTD_decompress``); without it a
  compressed checkpoint raises :class:`CheckpointError` naming libzstd.

Leaves come back as numpy arrays (``bfloat16`` ones as ``torch.bfloat16``
tensors, as in ``utils/serialization.py``), and orbax's ``scalar`` leaves
as Python numbers, in dicts and lists shaped as the saved tree.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import math
import os
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"

_MANIFEST_MAGIC = 0x0CDB3A2A
_BTREE_NODE_MAGIC = 0x0CDB20DE
_ZSTD_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_ZSTD_CONTENTSIZE_ERROR = (1 << 64) - 2


class CheckpointError(ValueError):
    """A checkpoint this reader cannot read, with what it met."""


def is_checkpoint(path: str) -> bool:
    """True for a directory orbax wrote (it holds ``_CHECKPOINT_METADATA``)."""
    return os.path.isdir(path) and os.path.exists(os.path.join(path, CHECKPOINT_METADATA))


# ---------------------------------------------------------------------------
# zstd (the system library) and CRC-32C
# ---------------------------------------------------------------------------

_zstd_lock = threading.Lock()
_zstd_lib: Optional[ctypes.CDLL] = None


def _zstd() -> ctypes.CDLL:
    global _zstd_lib
    with _zstd_lock:
        if _zstd_lib is None:
            lib = None
            for name in ("libzstd.so.1", ctypes.util.find_library("zstd")):
                if not name:
                    continue
                try:
                    lib = ctypes.CDLL(name)
                    break
                except OSError:
                    continue
            if lib is None:
                raise CheckpointError("this checkpoint is zstd-compressed and the system zstd library "
                                      "(libzstd.so.1) could not be loaded")
            lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
            lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
            lib.ZSTD_decompress.restype = ctypes.c_size_t
            lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
            lib.ZSTD_getErrorName.restype = ctypes.c_char_p
            lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
            _zstd_lib = lib
        return _zstd_lib


def zstd_available() -> bool:
    """Whether the system's zstd library loads (a compressed checkpoint needs it)."""
    try:
        _zstd()
        return True
    except CheckpointError:
        return False


def zstd_decompress(frame, max_size: int) -> np.ndarray:
    """One zstd frame -> its bytes (uint8).  ``max_size`` bounds the output
    where the frame does not state its content size."""
    lib = _zstd()
    src = bytes(frame)
    size = lib.ZSTD_getFrameContentSize(src, len(src))
    if size == _ZSTD_CONTENTSIZE_ERROR:
        raise CheckpointError("not a zstd frame")
    capacity = max_size if size == _ZSTD_CONTENTSIZE_UNKNOWN else int(size)
    if capacity > max_size:
        raise CheckpointError(f"zstd frame of {capacity} bytes, more than the {max_size} expected")
    out = np.empty(capacity, np.uint8)
    n = lib.ZSTD_decompress(out.ctypes.data, capacity, src, len(src))
    if lib.ZSTD_isError(n):
        raise CheckpointError(f"zstd: {lib.ZSTD_getErrorName(n).decode()}")
    return out[:n]


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli), as the OCDBT format checks each manifest and node."""
    crc, table = 0xFFFFFFFF, _CRC32C
    for b in bytes(data):
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------


class _Cursor:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            if self.pos >= len(self.buf):
                raise CheckpointError("OCDBT: data ends inside a varint")
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return out

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise CheckpointError("OCDBT: data ends inside a field")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]


def _unframe(raw: bytes, magic: int, what: str, max_size: int) -> memoryview:
    """A manifest or node's header (magic, length, version, compression)
    and CRC-32C footer checked; returns the body, decompressed."""
    if len(raw) < 18:
        raise CheckpointError(f"OCDBT {what}: {len(raw)} bytes, too short")
    got_magic, length = struct.unpack_from(">I", raw, 0)[0], struct.unpack_from("<Q", raw, 4)[0]
    if got_magic != magic:
        raise CheckpointError(f"OCDBT {what}: magic 0x{got_magic:08x}, expected 0x{magic:08x}")
    if length != len(raw):
        raise CheckpointError(f"OCDBT {what}: header says {length} bytes, read {len(raw)}")
    if crc32c(raw[:-4]) != struct.unpack_from("<I", raw, len(raw) - 4)[0]:
        raise CheckpointError(f"OCDBT {what}: CRC-32C mismatch")
    cur = _Cursor(raw)
    cur.pos = 12
    version, compression = cur.varint(), cur.varint()
    if version != 0:
        raise CheckpointError(f"OCDBT {what}: format version {version} (0 is read)")
    body = cur.buf[cur.pos:len(raw) - 4]
    if compression == 0:
        return body
    if compression == 1:
        return memoryview(zstd_decompress(body, max_size))
    raise CheckpointError(f"OCDBT {what}: compression format {compression} (0 none, 1 zstd are read)")


def _data_file_table(cur: _Cursor) -> List[str]:
    """The node's (or manifest's) data files, as paths below the store's root."""
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    base = cur.varints(n)  # the base path is the leading part of each path; it is read whole
    paths, prev = [], b""
    for i in range(n):
        path = prev[:prefix[i]] + bytes(cur.take(suffix[i]))
        if base[i] > len(path):
            raise CheckpointError("OCDBT: a data file's base path is longer than its path")
        paths.append(path.decode())
        prev = path
    return paths


class OcdbtStore:
    """The newest version of an OCDBT key-value store on a local disk."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        raw = self._read_file("manifest.ocdbt")
        cur = _Cursor(_unframe(raw, _MANIFEST_MAGIC, "manifest", 1 << 30))
        cur.take(16)  # uuid
        manifest_kind = cur.varint()
        if manifest_kind != 0:
            raise CheckpointError(f"OCDBT manifest kind {manifest_kind}: only single-file manifests (0) are read")
        cur.varint()  # max_inline_value_bytes
        self.max_decoded_node_bytes = cur.varint()
        cur.byte()  # version_tree_arity_log2
        method = cur.varint()
        if method == 1:
            cur.take(4)  # zstd level, int32le
        elif method != 0:
            raise CheckpointError(f"OCDBT compression method {method} (0 none, 1 zstd are read)")
        files = _data_file_table(cur)
        n = cur.varint()
        if n == 0:
            raise CheckpointError("OCDBT manifest holds no version")
        generation = cur.varints(n)
        height = list(cur.take(n))
        file_id, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
        newest = max(range(n), key=generation.__getitem__)
        self.values: Dict[bytes, Any] = {}
        if length[newest]:
            self._node(files[file_id[newest]], offset[newest], length[newest], height[newest], b"")

    def _read_file(self, rel: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        path = os.path.normpath(os.path.join(self.root, rel))
        if not path.startswith(self.root + os.sep):
            raise CheckpointError(f"OCDBT data file {rel!r} lies outside the checkpoint")
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read() if length is None else f.read(length)
        if length is not None and len(data) != length:
            raise CheckpointError(f"OCDBT data file {rel!r}: {len(data)} bytes at {offset}, expected {length}")
        return data

    def _node(self, file: str, offset: int, length: int, height: int, prefix: bytes) -> None:
        body = _unframe(self._read_file(file, offset, length), _BTREE_NODE_MAGIC, f"node {file}@{offset}",
                        max(self.max_decoded_node_bytes, 1 << 20))
        cur = _Cursor(body)
        if cur.byte() != height:
            raise CheckpointError(f"OCDBT node {file}@{offset}: height differs from its reference's {height}")
        files = _data_file_table(cur)
        n = cur.varint()
        key_prefix = [0] + cur.varints(n - 1) if n else []
        key_suffix = cur.varints(n)
        common = cur.varints(n) if height else []
        keys, prev = [], b""
        for i in range(n):
            key = prev[:key_prefix[i]] + bytes(cur.take(key_suffix[i]))
            keys.append(key)
            prev = key
        if height:
            file_id, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
            for i in range(n):
                # a child's keys omit the bytes all keys of its subtree share
                self._node(files[file_id[i]], offsets[i], lengths[i], height - 1, prefix + keys[i][:common[i]])
            return
        value_length, kind = cur.varints(n), cur.varints(n)
        indirect = [i for i in range(n) if kind[i] == 1]
        if any(k not in (0, 1) for k in kind):
            raise CheckpointError(f"OCDBT node {file}@{offset}: value kinds {sorted(set(kind))} (0, 1 are read)")
        file_id, offsets = cur.varints(len(indirect)), cur.varints(len(indirect))
        refs = dict(zip(indirect, zip(file_id, offsets)))
        for i in range(n):
            if i in refs:
                fid, off = refs[i]
                self.values[prefix + keys[i]] = (files[fid], off, value_length[i])
            else:
                self.values[prefix + keys[i]] = bytes(cur.take(value_length[i]))

    def get(self, key: str) -> Optional[bytes]:
        value = self.values.get(key.encode())
        if isinstance(value, tuple):
            return self._read_file(*value)
        return value


class DirectoryStore:
    """Keys as files below a directory (a checkpoint written with ``use_ocdbt=False``)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def get(self, key: str) -> Optional[bytes]:
        path = os.path.normpath(os.path.join(self.root, key))
        if not path.startswith(self.root + os.sep) or not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            return f.read()


# ---------------------------------------------------------------------------
# zarr v2
# ---------------------------------------------------------------------------


def _zarr_dtype(name: str) -> Tuple[np.dtype, bool]:
    """(the numpy dtype holding the stored bits, whether they are bfloat16)."""
    if name == "bfloat16":
        return np.dtype("<u2"), True
    try:
        dtype = np.dtype(name)
    except TypeError:
        dtype = None
    if dtype is None or dtype.kind not in "biufc":  # an ml_dtypes name resolves only where that is imported
        raise CheckpointError(f"zarr dtype {name!r} is not read (numpy's numeric dtypes and bfloat16 are)")
    return dtype, False


def _fill(value: Any, dtype: np.dtype, bf16: bool) -> Any:
    if value is None:
        return 0
    if bf16:
        f32 = np.array(float(value), np.float32).view(np.uint32)
        return int(f32 >> 16)
    if isinstance(value, str) and dtype.kind in "fc":
        return {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[value]
    return value


def read_zarr(store, name: str) -> Any:
    """The zarr v2 array stored under ``name/`` in ``store``."""
    meta_bytes = store.get(f"{name}/.zarray")
    if meta_bytes is None:
        raise CheckpointError(f"no zarr array {name!r} in the checkpoint")
    meta = json.loads(meta_bytes)
    if meta.get("zarr_format") != 2:
        raise CheckpointError(f"{name}: zarr_format {meta.get('zarr_format')} (2 is read)")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise CheckpointError(f"{name}: order {meta.get('order')!r} / filters {meta.get('filters')!r} "
                              "(C order without filters is read)")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise CheckpointError(f"{name}: compressor {compressor.get('id')!r} (zstd or none are read)")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dtype, bf16 = _zarr_dtype(meta["dtype"])
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value"), dtype, bf16), dtype)
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = sep.join(map(str, idx)) if idx else "0"
        raw = store.get(f"{name}/{key}")
        if raw is None:
            continue  # a chunk that was never written is the fill value
        data = zstd_decompress(raw, chunk_bytes) if compressor is not None else np.frombuffer(raw, np.uint8)
        if data.size != chunk_bytes:
            raise CheckpointError(f"{name}/{key}: {data.size} bytes, a chunk is {chunk_bytes}")
        chunk = data.view(dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    out = out.astype(dtype.newbyteorder("="), copy=False)
    if bf16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


# ---------------------------------------------------------------------------
# the checkpoint
# ---------------------------------------------------------------------------


def _nest(entries: List[Tuple[List[dict], Any]]) -> Any:
    """Leaves at key paths -> nested dicts, a level of sequence keys
    (``key_type`` 1) as a list in index order."""
    root: Dict[Any, Any] = {}
    sequences = set()
    for keys, value in entries:
        node = root
        for depth, k in enumerate(keys):
            key = k["key"]
            if k.get("key_type") == 1:
                sequences.add(id(node))
                key = int(key)
            if depth == len(keys) - 1:
                node[key] = value
            else:
                node = node.setdefault(key, {})

    def build(node):
        if not isinstance(node, dict):
            return node
        if id(node) in sequences:
            return [build(node[i]) for i in sorted(node)]
        return {k: build(v) for k, v in node.items()}

    return build(root)


def restore(path: str) -> Any:
    """The tree ``StandardCheckpointer().save(path, tree)`` wrote."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise CheckpointError(f"{path}: use_zarr3 checkpoints are not read (zarr v2 is)")
    store = OcdbtStore(path) if meta.get("use_ocdbt", True) else DirectoryStore(path)
    entries = []
    for entry in meta["tree_metadata"].values():
        keys, value = entry["key_metadata"], entry["value_metadata"]
        kind = value.get("value_type")
        if value.get("skip_deserialize"):
            raise CheckpointError(f"{path}: leaf {[k['key'] for k in keys]} is marked skip_deserialize")
        if kind not in ("jax.Array", "np.ndarray", "scalar"):
            raise CheckpointError(f"{path}: leaf {[k['key'] for k in keys]} has value type {kind!r} "
                                  "(jax.Array, np.ndarray and scalar are read)")
        arr = read_zarr(store, ".".join(str(k["key"]) for k in keys))
        entries.append((keys, arr.item() if kind == "scalar" else arr))
    return _nest(entries)

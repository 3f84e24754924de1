"""msgpack and flax's checkpoint format, without ``msgpack`` or ``flax``.

The JAX package writes and reads parameter trees with
``flax.serialization.to_bytes`` / ``from_bytes`` (``models/jaxserver.py``,
``models/generate.py``, ``models/paged.py``, ``components/outliers.py``).
This module is the port's own codec of the same bytes:

* :func:`packb` / :func:`unpackb`: the msgpack wire format (nil, bool,
  fixint and int / uint 8-64, float32 / float64, str 8/16/32, bin
  8/16/32, array and map 16/32, ext and fixext), as ``msgpack.packb``
  with ``use_bin_type=True`` and ``msgpack.unpackb`` emit and read it;
* flax's ext types: ``1`` an ndarray (a msgpack ``(shape, dtype name,
  bytes)``), ``2`` a Python complex, ``3`` a numpy scalar;
* arrays over :data:`MAX_CHUNK_SIZE` bytes are split into
  ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``
  and put back together on reading;
* :func:`to_bytes` is byte for byte ``flax.serialization.to_bytes`` of the
  same tree (dicts, lists and tuples become string-keyed maps), and :func:`from_bytes` restores onto a template as
  ``flax.serialization.from_bytes`` does.  A key the template has and the
  bytes lack is an error that names it, as in flax; so is a key the bytes
  have and the template lacks, which flax drops without a word.

Leaves come back as numpy arrays, except ``bfloat16`` ones, which numpy
cannot hold without ``ml_dtypes``: they come back as ``torch.bfloat16``
tensors with the stored bits.  :func:`to_numpy_tree` widens those to
float32 exactly (a bf16 value is a float32 with its low 16 bits zero).
:func:`to_bytes` takes numpy arrays and torch tensors (``bfloat16``
included) as leaves.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30

_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class ExtType(NamedTuple):
    """A msgpack extension value: a type code (-128..127) and its bytes."""

    code: int
    data: bytes


# ---------------------------------------------------------------------------
# msgpack
# ---------------------------------------------------------------------------


def _pack_int(obj: int, out: List[bytes]) -> bool:
    if 0 <= obj < 0x80:
        out.append(struct.pack("B", obj))
    elif -0x20 <= obj < 0:
        out.append(struct.pack("b", obj))
    elif 0x80 <= obj <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, obj))
    elif -0x80 <= obj < 0:
        out.append(struct.pack(">Bb", 0xD0, obj))
    elif 0xFF < obj <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, obj))
    elif -0x8000 <= obj < -0x80:
        out.append(struct.pack(">Bh", 0xD1, obj))
    elif 0xFFFF < obj <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, obj))
    elif -0x80000000 <= obj < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, obj))
    elif 0xFFFFFFFF < obj <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, obj))
    elif -0x8000000000000000 <= obj < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, obj))
    else:
        return False
    return True


def _pack_len(n: int, out: List[bytes], small: Optional[int], small_max: int, codes: tuple) -> None:
    """A length header: the fix form (``small`` | n) where there is one,
    else the 8 / 16 / 32-bit form (``codes``; None where the type has no
    8-bit form)."""
    if small is not None and n <= small_max:
        out.append(struct.pack("B", small | n))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack(">BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack cannot hold a length of {n}")


def _pack_bin(data, out: List[bytes]) -> None:
    data = bytes(data)
    _pack_len(len(data), out, None, 0, (0xC4, 0xC5, 0xC6))
    out.append(data)


def _pack_ext(ext: ExtType, out: List[bytes]) -> None:
    n = len(ext.data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack("B", fixed[n]))
    else:
        _pack_len(n, out, None, 0, (0xC7, 0xC8, 0xC9))
    out.append(struct.pack("b", ext.code))
    out.append(bytes(ext.data))


def _pack(obj: Any, out: List[bytes], default: Optional[Callable[[Any], Any]], strict: bool) -> None:
    def check(o, types):
        return type(o) in types if strict else isinstance(o, types)

    lists = (list,) if strict else (list, tuple)
    default_used = False
    while True:
        if obj is None:
            out.append(b"\xc0")
            return
        if check(obj, (bool,)):
            out.append(b"\xc3" if obj else b"\xc2")
            return
        if check(obj, (int,)):
            if _pack_int(obj, out):
                return
            if default is None or default_used:
                raise OverflowError("Integer value out of range")
        elif check(obj, (bytes, bytearray, memoryview)):
            _pack_bin(obj, out)
            return
        elif check(obj, (str,)):
            data = obj.encode("utf-8", "surrogatepass")
            _pack_len(len(data), out, 0xA0, 0x1F, (0xD9, 0xDA, 0xDB))
            out.append(data)
            return
        elif check(obj, (float,)):
            out.append(struct.pack(">Bd", 0xCB, obj))
            return
        elif check(obj, (ExtType,)):
            _pack_ext(obj, out)
            return
        elif check(obj, lists):
            _pack_len(len(obj), out, 0x90, 0x0F, (None, 0xDC, 0xDD))
            for item in obj:
                _pack(item, out, default, strict)
            return
        elif check(obj, (dict,)):
            _pack_len(len(obj), out, 0x80, 0x0F, (None, 0xDE, 0xDF))
            for k, v in obj.items():
                _pack(k, out, default, strict)
                _pack(v, out, default, strict)
            return
        if default is not None and not default_used:
            obj = default(obj)
            default_used = True
            continue
        raise TypeError(f"Cannot serialize {obj!r}")


def packb(obj: Any, default: Optional[Callable[[Any], Any]] = None, strict_types: bool = False) -> bytes:
    """``msgpack.packb(obj, default=..., strict_types=...)`` with
    ``use_bin_type=True`` and float64 floats: the same bytes.  With
    ``strict_types`` a subclass (a numpy float64, a tuple) goes to
    ``default`` instead of being packed as its base type."""
    out: List[bytes] = []
    _pack(obj, out, default, strict_types)
    return b"".join(out)


class _Reader:
    def __init__(self, data, raw: bool, ext_hook: Optional[Callable[[int, Any], Any]], bin_views: bool = False):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.raw = raw
        self.ext_hook = ext_hook
        self.bin_views = bin_views  # bin as a memoryview into the input, not a bytes copy

    def take(self, n: int):
        start, end = self.pos, self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data ends inside a value")
        self.pos = end
        return self.buf[start:end]

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        if self.pos + size > len(self.buf):
            raise ValueError("msgpack data ends inside a value")
        (value,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return value

    def string(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        return self.ext_hook(code, data) if self.ext_hook is not None else ExtType(code, bytes(data))

    def value(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            data = self.take(self.unpack({0xC4: "B", 0xC5: ">H", 0xC6: ">I"}[b]))
            return data if self.bin_views else bytes(data)
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: "B", 0xC8: ">H", 0xC9: ">I"}[b]))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.string(self.unpack({0xD9: "B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unused type byte 0x{b:02x} at offset {self.pos - 1}")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"msgpack map key {key!r} is not a str or bytes")
            out[key] = self.value()
        return out


def unpackb(data, raw: bool = False, ext_hook: Optional[Callable[[int, Any], Any]] = None) -> Any:
    """``msgpack.unpackb(data, raw=..., ext_hook=...)``: arrays come back as
    lists, str as ``str`` (``bytes`` when ``raw``), bin as ``bytes``; an
    extension goes to ``ext_hook(code, data)`` (``data`` a memoryview into
    the input, so an array's bytes are copied once), else it is an
    :class:`ExtType`.  Bytes left after the one value are an error."""
    reader = _Reader(data, raw, ext_hook)
    value = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes left after the value")
    return value


# ---------------------------------------------------------------------------
# flax's leaves: ndarray, complex, numpy scalar
# ---------------------------------------------------------------------------


def _array_parts(arr) -> tuple:
    """(shape, dtype name, C-order bytes) of a numpy array or a torch tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        arr = t.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of ndarrays.")
    return arr.shape, arr.dtype.name, arr.tobytes("C")


def _ndarray_to_bytes(arr) -> bytes:
    shape, name, data = _array_parts(arr)
    return packb((shape, name, data))


def _ndarray_from_bytes(data) -> Any:
    """An ext-1 payload -> a writable array (its bytes copied once)."""
    reader = _Reader(data, raw=True, ext_hook=None, bin_views=True)
    shape, name, buffer = reader.value()
    name = bytes(name).decode()
    if name == "bfloat16":
        bits = np.frombuffer(buffer, np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError:
        dtype = None
    if dtype is None or dtype.kind not in "biufc":  # an ml_dtypes name resolves only where that is imported
        raise ValueError(f"checkpoint array of dtype {name!r}: not a numpy dtype (bfloat16 is the one "
                         "extension type read)")
    return np.frombuffer(buffer, dtype=dtype).reshape(shape).copy()


def _ext_pack(x: Any) -> Any:
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return ExtType(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
    if isinstance(x, complex):
        return ExtType(_EXT_COMPLEX, packb((x.real, x.imag)))
    return x


def _ext_unpack(code: int, data) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    if code == _EXT_NPSCALAR:
        arr = _ndarray_from_bytes(data)
        return arr[()] if isinstance(arr, np.ndarray) else arr
    return ExtType(code, bytes(data))


# ---------------------------------------------------------------------------
# chunking of arrays over MAX_CHUNK_SIZE bytes
# ---------------------------------------------------------------------------


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(arr) -> Dict[str, Any]:
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _unchunk(data: Dict[str, Any]) -> Any:
    shape = tuple(data["shape"][str(i)] for i in range(len(data["shape"])))
    chunks = [data["chunks"][str(i)] for i in range(len(data["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _chunk_leaves(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _unchunk_leaves(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# flax's state dicts
# ---------------------------------------------------------------------------


def to_state_dict(target: Any) -> Any:
    """flax's state dict of a tree: dicts keep their keys as strings,
    lists and tuples become ``{"0": ..., "1": ...}``; anything else is a
    leaf."""
    if isinstance(target, dict):
        keys = {str(k) for k in target}
        if len(keys) != len(target):
            raise ValueError(f"Dict keys do not have a unique string representation: {keys} vs given: {target}")
        return {str(k): to_state_dict(v) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return {str(i): to_state_dict(x) for i, x in enumerate(target)}
    return target


def from_state_dict(target: Any, state: Any, path: str = ".") -> Any:
    """Restore ``state`` onto the structure of ``target``
    (``flax.serialization.from_state_dict``); the template's leaves are
    not used.  Keys missing on either side raise ``ValueError`` naming
    them and the path."""
    if isinstance(target, dict):
        if not isinstance(state, dict):
            raise ValueError(f"expected a dict at path {path}, the bytes hold {type(state).__name__}")
        missing = set(map(str, target)) - set(state)
        if missing:
            raise ValueError("The target dict keys and state dict keys do not match, target dict contains keys "
                             f"{missing} which are not present in state dict at path {path}")
        extra = set(state) - set(map(str, target))
        if extra:
            raise ValueError("The target dict keys and state dict keys do not match, state dict contains keys "
                             f"{extra} which are not present in the target dict at path {path}")
        return {k: from_state_dict(v, state[str(k)], f"{path}/{k}") for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(state, dict) or len(state) != len(target):
            got = len(state) if isinstance(state, dict) else type(state).__name__
            raise ValueError(f"The size of the list and the state dict do not match, got {len(target)} and "
                             f"{got} at path {path}")
        items = [from_state_dict(x, state[str(i)], f"{path}/{i}") for i, x in enumerate(target)]
        return tuple(items) if isinstance(target, tuple) else items
    return state


def msgpack_restore(data) -> Any:
    """``flax.serialization.msgpack_restore``: the bytes back to a tree of
    dicts and leaves, chunked arrays put back together."""
    return _unchunk_leaves(unpackb(data, ext_hook=_ext_unpack))


def to_bytes(target: Any) -> bytes:
    """``flax.serialization.to_bytes``: the same bytes for the same tree
    (arrays over ``MAX_CHUNK_SIZE`` split into chunks)."""
    return packb(_chunk_leaves(to_state_dict(target)), default=_ext_pack, strict_types=True)


def from_bytes(target: Any, data) -> Any:
    """``flax.serialization.from_bytes``: the tree in ``data`` restored
    onto the structure of ``target``."""
    return from_state_dict(target, msgpack_restore(data))


def to_numpy_tree(tree: Any) -> Any:
    """The tree with every torch tensor leaf as a numpy array;
    ``bfloat16`` widens to float32, which is exact."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu")
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree

"""Buffer-view payloads: the zero-copy SeldonMessage lane.

The proto path materialises every tensor payload at least twice between
the socket and the device (proto parse -> python ``bytes`` -> numpy ->
staging buffer), and the JSON path adds base64 on top.
:class:`BufferView` replaces that with one immutable triple ``(dtype,
shape, buffer)`` over the ingress byte buffer: decode is an
``np.frombuffer`` *view* (no copy, no dtype widening), and the server
stacks views into a device batch with a single copy per micro-batch (the
pinned staging buffer of ``codec/device.to_device``, the one copy the
hardware requires).

Wire format — **the SRT1 framing agreement**, shared with the C++ in
``native/`` (``srt1_item_size`` in ``codec.cc``, the fast-lane parser in
``frontserver.cc``) and with the JAX package's ``codec/bufview.py``:

    frame := magic u32 'S''R''T''1' | dtype u8 | ndim u8 | flags u16
           | shape i64[ndim] | payload bytes

* everything little-endian, payload C-order;
* the header is ``8 + 8*ndim`` bytes, a multiple of 8, so a frame at an
  aligned offset keeps its payload aligned for every dtype;
* dtype codes 0-3 are the table the C++ fast lane batches (it takes 0
  and 1); codes 4+ ride the Python buffer-view lane.

numpy has no bfloat16: a bfloat16 frame (code 5) keeps its 16-bit words
in the buffer, and ``array()`` widens them exactly to float32 (the
float32 whose upper half they are).  Packing a float32 array gives code
0, so the port never writes code 5.

``SELDON_TPU_ZERO_COPY=0`` turns every buffer-view lane off.

Not ported yet: the KV-handoff, migration and capture containers and the
CRC32C trailer (``ROADMAP.md`` §A items 8.10, 10 and 8.11).
"""

from __future__ import annotations

import math
import struct
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np

from seldon_core_tpu_torch.codec.tensor import PayloadError, ensure_little_endian, np_dtype

__all__ = [
    "SRT1_MAGIC",
    "SRT1_DTYPES",
    "MAX_NDIM",
    "MAX_ELEMS",
    "BufferView",
    "zero_copy_enabled",
    "dtype_code",
    "pack_frame",
    "unpack_frame",
    "pack_frames",
    "unpack_frames",
    "frame_header",
    "is_frame",
    "stack_views",
]

SRT1_MAGIC = 0x31545253  # "SRT1" little-endian
_MAGIC_BYTES = b"SRT1"

# dtype code -> wire dtype name; the C ABI mirror is srt1_item_size() in
# native/codec.cc (tests/test_torch_port_bufview.py holds them equal)
SRT1_DTYPES = (
    "float32",   # 0 (C++ fast lane)
    "uint8",     # 1 (C++ fast lane)
    "int32",     # 2
    "float64",   # 3
    "int8",      # 4
    "bfloat16",  # 5 (16-bit words; array() widens to float32)
    "float16",   # 6
    "int64",     # 7
    "uint16",    # 8
    "int16",     # 9
    "uint32",    # 10
    "uint64",    # 11
)

_CODE_BY_NAME = {name: code for code, name in enumerate(SRT1_DTYPES)}
_BF16_WORDS = np.dtype("<u2")
MAX_NDIM = 8
# element-count ceiling shared with native/codec.cc (kMaxElems): a shape
# whose product would wrap int64 fails validation, not a numpy reshape
MAX_ELEMS = 1 << 31


def zero_copy_enabled() -> bool:
    """``SELDON_TPU_ZERO_COPY=0`` turns every buffer-view lane off."""
    from seldon_core_tpu_torch.runtime import knobs

    return knobs.flag("SELDON_TPU_ZERO_COPY")


def _wire_dtype(name: str) -> np.dtype:
    """The numpy dtype of the payload bytes as they lie in the buffer."""
    return _BF16_WORDS if name == "bfloat16" else np_dtype(name)


def _byte_view(buffer: Union[bytes, bytearray, memoryview, np.ndarray]) -> memoryview:
    """A flat uint8 memoryview over ``buffer`` without copying (zero-size
    buffers, which ``cast("B")`` refuses, give an empty view)."""
    mv = buffer if isinstance(buffer, memoryview) else memoryview(buffer)
    if mv.ndim == 1 and mv.format in ("B", "b", "c"):
        return mv.cast("B") if mv.format != "B" else mv
    if mv.nbytes == 0:
        return memoryview(b"")
    return mv.cast("B")


def dtype_code(dtype: np.dtype) -> int:
    """The SRT1 wire code for ``dtype`` (PayloadError when it has none:
    strings and objects travel the ndarray / JSON path)."""
    code = _CODE_BY_NAME.get(np.dtype(dtype).name)
    if code is None:
        raise PayloadError(
            f"dtype {np.dtype(dtype).name!r} has no SRT1 wire code "
            f"(supported: {', '.join(SRT1_DTYPES)})"
        )
    return code


class BufferView:
    """One tensor payload as ``(dtype, shape, buffer)``: no python lists,
    no copy.  ``array()`` is an ``np.frombuffer`` view over the buffer
    (read-only when the buffer is); ``np.asarray`` on a view resolves
    through ``__array__``, so components consume views unchanged.

    ``wire`` names the dtype of the bytes in the buffer.  It equals
    ``dtype.name`` except for bfloat16, whose words ``array()`` widens to
    float32 (``dtype``) with one pass.  ``copied`` records whether making
    the view had to copy (a non-contiguous source array)."""

    __slots__ = ("dtype", "wire", "shape", "_mv", "copied", "_arr")

    def __init__(
        self,
        dtype: Any,
        shape: Sequence[int],
        buffer: Union[bytes, bytearray, memoryview, np.ndarray],
        offset: int = 0,
        copied: bool = False,
    ):
        self.wire = dtype if isinstance(dtype, str) else np.dtype(dtype).name
        self.dtype = np_dtype(self.wire)
        self.shape = tuple(int(d) for d in shape)
        if any(d < 0 for d in self.shape):
            raise PayloadError(f"negative dimension in shape {self.shape}")
        mv = _byte_view(buffer)
        # exact python-int product: an attacker-sized shape cannot wrap
        elems = math.prod(self.shape) if self.shape else 1
        if elems > MAX_ELEMS:
            raise PayloadError(
                f"shape {self.shape} holds {elems} elements, over the "
                f"{MAX_ELEMS} framing ceiling"
            )
        need = elems * _wire_dtype(self.wire).itemsize
        if offset < 0 or offset + need > len(mv):
            raise PayloadError(
                f"buffer of {len(mv)} bytes cannot hold {self.shape} "
                f"{self.wire} at offset {offset} (needs {need} bytes)"
            )
        self._mv = mv[offset:offset + need]
        self.copied = bool(copied)
        self._arr: Optional[np.ndarray] = None

    # ---- constructors -----------------------------------------------------

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "BufferView":
        """Wrap an ndarray: C-contiguous arrays in place (zero copy),
        others compacted once and flagged ``copied``."""
        arr = np.asarray(arr)
        copied = not arr.flags["C_CONTIGUOUS"]
        if copied:
            arr = np.ascontiguousarray(arr)
        view = cls(arr.dtype, arr.shape, _byte_view(arr), copied=copied)
        view._arr = arr  # keep the exact array (and its writability)
        return view

    @classmethod
    def from_bytes(
        cls, data: Union[bytes, memoryview], dtype: Any,
        shape: Sequence[int], offset: int = 0,
    ) -> "BufferView":
        """View over raw little-endian payload bytes of wire dtype
        ``dtype``; a byte count that is not a whole number of elements
        raises a :class:`PayloadError` naming the offset."""
        name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
        item = _wire_dtype(name).itemsize
        mv = _byte_view(data)
        avail = len(mv) - offset
        if offset < 0 or avail < 0:
            raise PayloadError(
                f"offset {offset} is outside the {len(mv)}-byte buffer"
            )
        if shape is None or len(tuple(shape)) == 0:
            if avail != item:
                raise PayloadError(
                    f"scalar {name} payload at offset {offset} must be "
                    f"{item} bytes, got {avail}"
                )
            return cls(name, (), mv, offset=offset)
        if avail % item:
            raise PayloadError(
                f"misaligned rawTensor payload: {avail} bytes at offset "
                f"{offset} is not a multiple of {name} itemsize {item}"
            )
        return cls(name, shape, mv, offset=offset)

    # ---- accessors --------------------------------------------------------

    @property
    def nbytes(self) -> int:
        return len(self._mv)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def array(self) -> np.ndarray:
        """The payload as an ndarray (cached): a VIEW over the buffer, or
        for bfloat16 its exact float32 widening."""
        if self._arr is None:
            arr = np.frombuffer(self._mv, dtype=_wire_dtype(self.wire))
            if self.wire == "bfloat16":
                arr = (arr.astype(np.uint32) << 16).view(np.float32)
            self._arr = arr.reshape(self.shape)
        return self._arr

    def __array__(self, dtype=None, copy=None):
        arr = self.array()
        if dtype is not None and np.dtype(dtype) != arr.dtype:
            return arr.astype(dtype)
        if copy:
            return arr.copy()
        return arr

    def tobytes(self) -> bytes:
        """The payload bytes as they lie on the wire."""
        return self._mv.tobytes()

    def to_device(self, device):
        """One staged copy straight off the buffer onto ``device``
        (``codec/device.to_device``); returns a ``torch.Tensor``."""
        from seldon_core_tpu_torch.codec.device import to_device

        return to_device(self.array(), device)

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("len() of a 0-d BufferView")
        return self.shape[0]

    def __repr__(self) -> str:
        tag = "copied" if self.copied else "zero-copy"
        return f"BufferView({self.wire}, shape={self.shape}, {tag}, {self.nbytes}B)"


# ---------------------------------------------------------------------------
# SRT1 frame codec
# ---------------------------------------------------------------------------


def is_frame(data: Union[bytes, memoryview]) -> bool:
    """Does ``data`` start with the SRT1 magic?  (A JSON or proto body
    cannot.)"""
    return len(data) >= 8 and bytes(memoryview(data)[:4]) == _MAGIC_BYTES


def frame_header(dtype: np.dtype, shape: Sequence[int]) -> bytes:
    """The ``8 + 8*ndim``-byte SRT1 header for one payload."""
    shape = tuple(int(d) for d in shape)
    if len(shape) > MAX_NDIM:
        raise PayloadError(f"SRT1 frames carry at most {MAX_NDIM} dims, got {len(shape)}")
    head = struct.pack("<IBBH", SRT1_MAGIC, dtype_code(dtype), len(shape), 0)
    return head + struct.pack(f"<{len(shape)}q", *shape)


def pack_frame(payload: Union[np.ndarray, BufferView]) -> bytes:
    """Encode one array / view as an SRT1 frame (header + payload);
    big-endian sources are byteswapped (the wire is little-endian)."""
    arr = payload.array() if isinstance(payload, BufferView) else np.asarray(payload)
    arr = ensure_little_endian(arr)
    if not arr.flags["C_CONTIGUOUS"]:
        arr = np.ascontiguousarray(arr)
    return frame_header(arr.dtype, arr.shape) + arr.tobytes()


def _parse_header(mv: memoryview, offset: int) -> Tuple[str, Tuple[int, ...], int, int]:
    """Validate one frame header at ``offset``: returns ``(wire dtype
    name, shape, payload_offset, payload_bytes)``.  A malformed header
    raises :class:`PayloadError` naming the defect and its byte offset."""
    if len(mv) - offset < 8:
        raise PayloadError(
            f"truncated SRT1 frame: {len(mv) - offset} bytes at offset "
            f"{offset} (header needs 8)"
        )
    magic, code, ndim, _flags = struct.unpack_from("<IBBH", mv, offset)
    if magic != SRT1_MAGIC:
        raise PayloadError(f"bad SRT1 magic 0x{magic:08x} at offset {offset}")
    if code >= len(SRT1_DTYPES):
        raise PayloadError(f"unknown SRT1 dtype code {code} at offset {offset + 4}")
    if ndim > MAX_NDIM:
        raise PayloadError(f"SRT1 ndim {ndim} exceeds {MAX_NDIM} at offset {offset + 5}")
    shape_off = offset + 8
    if len(mv) < shape_off + 8 * ndim:
        raise PayloadError(
            f"truncated SRT1 shape: frame ends inside the {ndim}-dim "
            f"shape block at offset {shape_off}"
        )
    shape = struct.unpack_from(f"<{ndim}q", mv, shape_off)
    if any(d < 0 for d in shape):
        raise PayloadError(f"negative SRT1 dimension in {shape} at offset {shape_off}")
    # the per-dimension and total ceilings of native/codec.cc
    # (srt1_payload_bytes), so both refuse the same frames
    if any(d > MAX_ELEMS for d in shape):
        raise PayloadError(
            f"SRT1 dimension over the {MAX_ELEMS} framing ceiling in "
            f"{tuple(shape)} at offset {shape_off}"
        )
    elems = math.prod(shape) if ndim else 1
    if elems > MAX_ELEMS:
        raise PayloadError(
            f"SRT1 shape {tuple(shape)} at offset {shape_off} holds "
            f"{elems} elements, over the {MAX_ELEMS} framing ceiling"
        )
    name = SRT1_DTYPES[code]
    return name, tuple(shape), shape_off + 8 * ndim, elems * _wire_dtype(name).itemsize


def unpack_frame(data: Union[bytes, memoryview], offset: int = 0) -> BufferView:
    """Decode one SRT1 frame into a :class:`BufferView` over ``data``
    (zero copy).  The frame must fill the buffer; multi-tensor bodies
    use :func:`unpack_frames`."""
    mv = _byte_view(data)
    name, shape, payload_off, need = _parse_header(mv, offset)
    avail = len(mv) - payload_off
    if avail != need:
        raise PayloadError(
            f"SRT1 payload at offset {payload_off} carries {avail} bytes "
            f"but shape {shape} {name} needs {need}"
        )
    return BufferView(name, shape, mv, offset=payload_off)


def pack_frames(payloads: Sequence[Union[np.ndarray, BufferView]]) -> bytes:
    """The multi-tensor container: N frames back to back, each padded to
    an 8-byte boundary before the next (int8 / f16 tails are not
    multiples of 8).  One frame is byte-identical to :func:`pack_frame`."""
    if not payloads:
        raise PayloadError("pack_frames needs at least one payload")
    frames = [pack_frame(p) for p in payloads]
    parts = []
    for i, frame in enumerate(frames):
        parts.append(frame)
        pad = -len(frame) % 8
        if pad and i < len(frames) - 1:
            parts.append(b"\x00" * pad)
    return b"".join(parts)


def unpack_frames(data: Union[bytes, memoryview]) -> list:
    """Decode a multi-frame container into zero-copy views (zero padding
    to 8 bytes between frames; a trailing pad after the last frame is
    tolerated)."""
    mv = _byte_view(data)
    views = []
    offset = 0
    while offset < len(mv):
        name, shape, payload_off, need = _parse_header(mv, offset)
        if payload_off + need > len(mv):
            raise PayloadError(
                f"SRT1 payload at offset {payload_off} needs {need} bytes "
                f"but the container ends at {len(mv)}"
            )
        views.append(BufferView(name, shape, mv, offset=payload_off))
        offset = payload_off + need
        pad = -offset % 8
        tail = bytes(mv[offset:offset + pad])
        if tail.strip(b"\x00"):
            raise PayloadError(
                f"non-zero inter-frame padding at offset {offset} "
                "(frames must be 8-byte aligned; see pack_frames)"
            )
        if len(tail) < pad:
            break  # the last frame: its trailing pad is absent
        offset += pad
    if not views:
        raise PayloadError("empty SRT1 container")
    return views


def stack_views(
    views: Sequence[Union[BufferView, np.ndarray]],
    dtype: Optional[np.dtype] = None,
) -> Tuple[np.ndarray, list]:
    """Stack N row-batched views ``[rows_i, *tail]`` into ONE contiguous
    micro-batch and the per-view row offsets (to split outputs back).

    One allocation and one copy pass; a single view that already forms
    the whole batch passes through with no copy.  Views must agree on
    dtype and trailing shape."""
    if not views:
        raise PayloadError("stack_views needs at least one view")
    arrs = [v.array() if isinstance(v, BufferView) else np.asarray(v) for v in views]
    tail = arrs[0].shape[1:]
    dt = dtype or arrs[0].dtype
    for i, a in enumerate(arrs):
        if a.ndim < 1 or a.shape[1:] != tail or a.dtype != dt:
            raise PayloadError(
                f"view {i} ({a.dtype.name}{a.shape}) does not stack with "
                f"view 0 ({dt.name}[rows, {', '.join(map(str, tail))}])"
            )
    offsets = [0]
    for a in arrs:
        offsets.append(offsets[-1] + a.shape[0])
    if len(arrs) == 1:
        return arrs[0], offsets
    batch = np.empty((offsets[-1], *tail), dtype=dt)
    for a, start in zip(arrs, offsets):
        batch[start:start + a.shape[0]] = a
    return batch, offsets

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

The KV-page handoff and live-migration containers ride the same frames
with a CRC32C trailer (``SRTC | crc32c``, ``SELDON_TPU_KV_CHECKSUM``),
byte for byte the JAX package's, so a container one package writes the
other reads.  Their bfloat16 pages travel as code-5 frames of the pool's
own words and come back as ``torch.bfloat16`` tensors.

Not ported yet: the capture container (``ROADMAP.md`` §A item 8.11).
"""

from __future__ import annotations

import math
import struct
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np

from seldon_core_tpu_torch.codec.tensor import PayloadError, ensure_little_endian, np_dtype

__all__ = [
    "SRT1_MAGIC",
    "SRT1_CRC_MAGIC",
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
    "crc32c",
    "crc32c_impl",
    "kv_checksum_enabled",
    "pack_kv_handoff",
    "unpack_kv_handoff",
    "pack_kv_migration",
    "unpack_kv_migration",
]

SRT1_MAGIC = 0x31545253  # "SRT1" little-endian
_MAGIC_BYTES = b"SRT1"
SRT1_CRC_MAGIC = 0x43545253  # "SRTC" little-endian: the KV containers' trailer

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
    return _join_frames([pack_frame(p) for p in payloads])


def _join_frames(frames: Sequence[bytes]) -> bytes:
    """Encoded frames back to back, each padded to 8 bytes before the next."""
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


# ---------------------------------------------------------------------------
# CRC32C integrity trailer (the JAX package's bufview.py:416-545)
# ---------------------------------------------------------------------------

# Castagnoli CRC32 (iSCSI polynomial 0x1EDC6F41, reflected 0x82F63B78):
# zlib.crc32 is the other polynomial.  The C twin is srt1_crc32c in
# native/codec.cc; the tests hold the two equal.
_CRC32C_POLY = 0x82F63B78


def _crc32c_table() -> Tuple[int, ...]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ _CRC32C_POLY if crc & 1 else crc >> 1
        table.append(crc)
    return tuple(table)


_CRC32C_TABLE = _crc32c_table()


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# the native srt1_crc32c, resolved once on first use (None: not yet,
# False: no library)
_CRC_NATIVE: Any = None


def _crc_native():
    global _CRC_NATIVE
    if _CRC_NATIVE is None:
        try:
            from seldon_core_tpu_torch.native import get_lib

            lib = get_lib()
            _CRC_NATIVE = lib.srt1_crc32c if lib is not None else False
        except Exception:  # noqa: BLE001 — the table loop is the same polynomial
            _CRC_NATIVE = False
    return _CRC_NATIVE


def crc32c(data: Union[bytes, bytearray, memoryview], crc: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``, chainable through ``crc``.  The
    native library's ``srt1_crc32c`` when it loads (a KV container runs
    to megabytes and the table loop prices ~5 MB/s), else the table
    loop; the two agree bit for bit."""
    if not isinstance(data, bytes):
        data = bytes(data)
    fn = _crc_native()
    if fn:
        return int(fn(data, len(data), crc)) & 0xFFFFFFFF
    return _crc32c_py(data, crc)


def crc32c_impl() -> str:
    """Which CRC32C :func:`crc32c` runs: ``"native"`` or ``"table"``."""
    return "native" if _crc_native() else "table"


def kv_checksum_enabled() -> bool:
    """``SELDON_TPU_KV_CHECKSUM=0`` drops the KV containers' CRC32C
    trailer (default on)."""
    from seldon_core_tpu_torch.runtime import knobs

    return knobs.flag("SELDON_TPU_KV_CHECKSUM")


def _append_crc_trailer(body: bytes) -> bytes:
    """Pad ``body`` to 8 bytes and append the ``SRTC | crc32c`` trailer
    (8 bytes, so the container stays 8-aligned end to end)."""
    pad = -len(body) % 8
    if pad:
        body = body + b"\x00" * pad
    return body + struct.pack("<II", SRT1_CRC_MAGIC, crc32c(body))


def _frames_end(mv: memoryview) -> int:
    """Byte offset where the container's frame run ends, walking the
    headers as :func:`unpack_frames` does (structural, never a byte
    scan: payload bytes cannot pass for a trailer)."""
    offset = 0
    while offset < len(mv):
        if len(mv) - offset < 8 or bytes(mv[offset:offset + 4]) != _MAGIC_BYTES:
            break
        _dt, _shape, payload_off, need = _parse_header(mv, offset)
        if payload_off + need > len(mv):
            break
        offset = payload_off + need
        pad = -offset % 8
        if bytes(mv[offset:offset + pad]).strip(b"\x00"):
            break  # non-zero pad: unpack_frames raises its error
        offset += min(pad, len(mv) - offset)
    return offset


def _split_crc_trailer(data) -> Tuple[memoryview, bool]:
    """Verify and strip the CRC32C trailer when there is one: the body
    (frames only) and whether a trailer was seen.  A wrong checksum
    raises :class:`PayloadError` naming the trailer offset and both
    sums; with the checksum knob off the trailer is stripped unverified."""
    mv = _byte_view(data)
    end = _frames_end(mv)
    if len(mv) - end < 8:
        return mv, False
    magic, stored = struct.unpack_from("<II", mv, len(mv) - 8)
    if magic != SRT1_CRC_MAGIC:
        return mv, False
    body = mv[: len(mv) - 8]
    if kv_checksum_enabled():
        actual = crc32c(body)
        if actual != stored:
            raise PayloadError(
                f"KV container CRC32C mismatch at trailer offset "
                f"{len(mv) - 8}: stored 0x{stored:08x}, computed "
                f"0x{actual:08x} over {len(body)} bytes — payload "
                "corrupted in transit, refusing to scatter garbage KV"
            )
    return body, True


# ---------------------------------------------------------------------------
# KV-page handoff and live-migration containers (bufview.py:546-856)
# ---------------------------------------------------------------------------

# Fixed frame order of one handoff container: the pool layout follows
# from k's rank (4 = flat (L, P, ps, d_model), 5 = split (L, P, ps, h,
# hd)), page_size from k.shape[2], the vocabulary from last_logits.
_KV_HANDOFF_FRAMES = ("prompt", "last_logits", "k", "v")

# int8 pools append the per-page scale tables (num_layers, pages) for k
# and v: their presence is the layout signal
_KV_SCALE_FRAMES = ("k_scales", "v_scales")

# the migration container: the handoff's frames plus the decoded
# tokens, the stream's sampler state as uint32 words and a uint8 JSON
# meta frame with the scalar recipe
_KV_MIGRATION_FRAMES = ("prompt", "last_logits", "k", "v", "tokens", "key_data", "meta")

_MIGRATION_META_FIELDS = (
    "req_id", "max_new_tokens", "temperature", "top_k", "eos_id", "seed",
    "priority", "deadline_remaining_ms", "streamed", "stream_tokens",
    "adapter", "pending", "page_size", "layout",
)


def _kv_source(x):
    """A page stack as it is framed: a numpy array, or a bfloat16
    :class:`BufferView` over the pool's own 16-bit words (a
    ``torch.bfloat16`` tensor or a bfloat16 view)."""
    if isinstance(x, BufferView):
        return x if x.wire == "bfloat16" else x.array()
    if type(x).__module__.split(".")[0] == "torch":
        import torch

        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return BufferView("bfloat16", t.shape, t.view(torch.int16).numpy())
        return t.numpy()
    return np.asarray(x)


def _dtype_name(a) -> str:
    return a.wire if isinstance(a, BufferView) else a.dtype.name


def _kv_frame(a) -> bytes:
    if isinstance(a, BufferView):
        head = struct.pack("<IBBH", SRT1_MAGIC, _CODE_BY_NAME["bfloat16"], a.ndim, 0)
        return head + struct.pack(f"<{a.ndim}q", *a.shape) + a.tobytes()
    return pack_frame(a)


def _kv_pages(view: BufferView):
    """A k / v frame as the engines take it: a numpy view, or for
    bfloat16 pages a ``torch.bfloat16`` tensor (numpy has no bfloat16)."""
    if view.wire != "bfloat16":
        return view.array()
    import torch

    words = torch.frombuffer(bytearray(view.tobytes()), dtype=torch.int16)
    return words.view(torch.bfloat16).reshape(view.shape)


def _check_kv_scales(k, sk, sv, kind: str):
    """The optional int8 scale frames: int8 pages need them, they need
    int8 pages, and each prices every page, ``(num_layers, pages)`` in
    float32.  ``k`` is the page stack's ``(dtype name, shape)``."""
    k_dtype, k_shape = k
    if sk is None:
        if k_dtype == "int8":
            raise PayloadError(
                f"KV {kind} carries int8 pages but no per-page scale "
                f"frames ({', '.join(_KV_SCALE_FRAMES)})"
            )
        return
    if k_dtype != "int8":
        raise PayloadError(
            f"KV {kind} carries scale frames but {k_dtype} pages "
            f"(scales only accompany int8 pages)"
        )
    for name, s in zip(_KV_SCALE_FRAMES, (sk, sv)):
        if s.dtype != np.float32 or s.ndim != 2 or s.shape[1] != k_shape[1]:
            raise PayloadError(
                f"KV {kind} {name} must be float32 (num_layers, pages="
                f"{int(k_shape[1])}), got "
                f"{np.dtype(s.dtype).name}{tuple(s.shape)}"
            )
    if sk.shape != sv.shape or sk.shape[0] != k_shape[0]:
        raise PayloadError(
            f"KV {kind} scale tables must both be "
            f"({int(k_shape[0])}, {int(k_shape[1])}), got "
            f"{tuple(sk.shape)} vs {tuple(sv.shape)}"
        )


def _kv_stacks(payload: dict, kind: str):
    """The payload's k / v as frame sources, checked to be matching
    rank-4 or rank-5 page stacks, and its scale tables (None for a
    native-dtype pool)."""
    k, v = _kv_source(payload["k"]), _kv_source(payload["v"])
    if (k.ndim not in (4, 5) or tuple(k.shape) != tuple(v.shape)
            or _dtype_name(k) != _dtype_name(v)):
        raise PayloadError(
            f"KV {kind} k/v must be matching rank-4 (flat) or rank-5 "
            f"(split) page stacks, got {_dtype_name(k)}{tuple(k.shape)} vs "
            f"{_dtype_name(v)}{tuple(v.shape)}"
        )
    scales = None
    if any(name in payload for name in _KV_SCALE_FRAMES) or _dtype_name(k) == "int8":
        try:
            scales = [np.asarray(_kv_source(payload[n]), np.float32) for n in _KV_SCALE_FRAMES]
        except KeyError as exc:
            raise PayloadError(
                f"KV {kind} int8 payload is missing the {exc.args[0]!r} "
                f"scale entry (int8 pages need {', '.join(_KV_SCALE_FRAMES)})"
            ) from None
        _check_kv_scales((_dtype_name(k), tuple(k.shape)), scales[0], scales[1], kind)
    return k, v, scales


def _seal(frames: Sequence[bytes]) -> bytes:
    body = _join_frames(frames)
    return _append_crc_trailer(body) if kv_checksum_enabled() else body


def pack_kv_handoff(payload: dict) -> bytes:
    """Encode a ``PagedEngine.prefill_export`` payload (prompt, last
    logits, k / v page stacks, int8 scales) as one SRT1 container with
    the CRC32C trailer: the wire form of the KV-page handoff."""
    missing = [name for name in _KV_HANDOFF_FRAMES if name not in payload]
    if missing:
        raise PayloadError(
            f"KV handoff payload is missing the {missing[0]!r} entry "
            f"(needs {', '.join(_KV_HANDOFF_FRAMES)})"
        )
    prompt = np.asarray(_kv_source(payload["prompt"]))
    if prompt.ndim != 1 or prompt.size < 1:
        raise PayloadError(
            f"KV handoff prompt must be a non-empty 1-D token array, got "
            f"shape {tuple(prompt.shape)}"
        )
    last = np.asarray(_kv_source(payload["last_logits"]), np.float32).reshape(-1)
    k, v, scales = _kv_stacks(payload, "handoff")
    return _seal([pack_frame(prompt.astype(np.int32, copy=False)), pack_frame(last), _kv_frame(k), _kv_frame(v)]
                 + [pack_frame(s) for s in scales or []])


def unpack_kv_handoff(data) -> dict:
    """Decode one KV-handoff container (the CRC32C trailer verified
    first) into the payload ``PagedEngine.submit_prefilled`` takes:
    numpy views over ``data``, bfloat16 pages as ``torch.bfloat16``.  A
    malformed container raises :class:`PayloadError` naming the defect."""
    body, _ = _split_crc_trailer(data)
    views = unpack_frames(body)
    n_plain = len(_KV_HANDOFF_FRAMES)
    if len(views) not in (n_plain, n_plain + len(_KV_SCALE_FRAMES)):
        raise PayloadError(
            f"KV handoff container carries {len(views)} frames, expected "
            f"{n_plain} ({', '.join(_KV_HANDOFF_FRAMES)}) or "
            f"{n_plain + len(_KV_SCALE_FRAMES)} (+ "
            f"{', '.join(_KV_SCALE_FRAMES)} for int8 pools)"
        )
    prompt, last, k, v = views[:n_plain]
    sk = sv = None
    if len(views) > n_plain:
        sk, sv = (s.array() for s in views[n_plain:])
    if prompt.wire != "int32" or prompt.ndim != 1 or len(prompt) < 1:
        raise PayloadError(
            f"KV handoff prompt frame must be 1-D int32, got "
            f"{prompt.wire}{prompt.shape}"
        )
    if last.wire != "float32" or last.ndim != 1:
        raise PayloadError(
            f"KV handoff last_logits frame must be 1-D float32, got "
            f"{last.wire}{last.shape}"
        )
    if k.ndim not in (4, 5) or k.shape != v.shape or k.wire != v.wire:
        raise PayloadError(
            f"KV handoff k/v frames must be matching rank-4/5 page "
            f"stacks, got {k.wire}{k.shape} vs {v.wire}{v.shape}"
        )
    _check_kv_scales((k.wire, k.shape), sk, sv, "handoff")
    page_size = int(k.shape[2])
    pages = int(k.shape[1])
    if page_size < 1 or pages != -(-len(prompt) // page_size):
        raise PayloadError(
            f"KV handoff geometry mismatch: {len(prompt)} prompt tokens "
            f"need {-(-len(prompt) // max(1, page_size))} pages of "
            f"{page_size}, container holds {pages}"
        )
    out = {
        "prompt": prompt.array(),
        "last_logits": last.array(),
        "k": _kv_pages(k),
        "v": _kv_pages(v),
        "page_size": page_size,
        "layout": "flat" if k.ndim == 4 else "split",
    }
    if sk is not None:
        out["k_scales"], out["v_scales"] = sk, sv
    return out


def pack_kv_migration(payload: dict) -> bytes:
    """Encode a ``PagedEngine.migrate_export`` payload as one SRT1
    container with the CRC32C trailer: the wire form of live-stream
    migration (in process the payload dict passes by reference)."""
    import json

    for name in ("prompt", "k", "v", "last_logits"):
        if name not in payload:
            raise PayloadError(
                f"KV migration payload is missing the {name!r} entry "
                f"(needs {', '.join(_KV_MIGRATION_FRAMES)})"
            )
    prompt = np.asarray(_kv_source(payload["prompt"]), np.int32).reshape(-1)
    if prompt.size < 1:
        raise PayloadError("KV migration prompt must be non-empty")
    k, v, scales = _kv_stacks(payload, "migration")
    meta = {name: payload.get(name) for name in _MIGRATION_META_FIELDS}
    meta_frame = np.frombuffer(json.dumps(meta).encode("utf-8"), np.uint8)
    return _seal([
        pack_frame(prompt),
        pack_frame(np.asarray(_kv_source(payload["last_logits"]), np.float32).reshape(-1)),
        _kv_frame(k), _kv_frame(v),
        pack_frame(np.asarray(_kv_source(payload.get("tokens", [])), np.int32).reshape(-1)),
        pack_frame(np.asarray(_kv_source(payload.get("key_data", [])), np.uint32).reshape(-1)),
        pack_frame(meta_frame),
    ] + [pack_frame(s) for s in scales or []])


def unpack_kv_migration(data) -> dict:
    """Decode one migration container (the CRC32C trailer verified
    first) into the payload ``PagedEngine.migrate_import`` takes.  A
    malformed container raises :class:`PayloadError` naming the defect."""
    import json

    body, _ = _split_crc_trailer(data)
    views = unpack_frames(body)
    n_plain = len(_KV_MIGRATION_FRAMES)
    if len(views) not in (n_plain, n_plain + len(_KV_SCALE_FRAMES)):
        raise PayloadError(
            f"KV migration container carries {len(views)} frames, "
            f"expected {n_plain} ({', '.join(_KV_MIGRATION_FRAMES)}) or "
            f"{n_plain + len(_KV_SCALE_FRAMES)} (+ "
            f"{', '.join(_KV_SCALE_FRAMES)} for int8 pools)"
        )
    prompt, last, k, v, tokens, key_data, meta_v = views[:n_plain]
    sk = sv = None
    if len(views) > n_plain:
        sk, sv = (s.array() for s in views[n_plain:])
    if prompt.wire != "int32" or prompt.ndim != 1 or len(prompt) < 1:
        raise PayloadError(
            f"KV migration prompt frame must be 1-D int32, got "
            f"{prompt.wire}{prompt.shape}"
        )
    if k.ndim not in (4, 5) or k.shape != v.shape or k.wire != v.wire:
        raise PayloadError(
            f"KV migration k/v frames must be matching rank-4/5 page "
            f"stacks, got {k.wire}{k.shape} vs {v.wire}{v.shape}"
        )
    if tokens.wire != "int32" or tokens.ndim != 1:
        raise PayloadError(
            f"KV migration tokens frame must be 1-D int32, got "
            f"{tokens.wire}{tokens.shape}"
        )
    _check_kv_scales((k.wire, k.shape), sk, sv, "migration")
    try:
        meta = json.loads(bytes(meta_v.array()).decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as exc:
        raise PayloadError(f"KV migration meta frame is not JSON: {exc}") from exc
    page_size = int(k.shape[2])
    total = len(prompt) + len(tokens)
    if page_size < 1 or int(k.shape[1]) != -(-total // page_size):
        raise PayloadError(
            f"KV migration geometry mismatch: {len(prompt)} prompt + "
            f"{len(tokens)} decoded tokens need "
            f"{-(-total // max(1, page_size))} pages of {page_size}, "
            f"container holds {int(k.shape[1])}"
        )
    out = {
        "prompt": prompt.array(),
        "last_logits": last.array(),
        "k": _kv_pages(k),
        "v": _kv_pages(v),
        "tokens": tokens.array(),
        "key_data": key_data.array(),
        "page_size": page_size,
        "layout": "flat" if k.ndim == 4 else "split",
    }
    if sk is not None:
        out["k_scales"], out["v_scales"] = sk, sv
    out.update({f: meta.get(f) for f in _MIGRATION_META_FIELDS if f not in ("page_size", "layout")})
    return out

"""The port's SRT1 framing (``codec/bufview.py``) against the JAX package's.

The same numpy arrays go through both packages' ``pack_frame`` /
``pack_frames``: the bytes must be equal for every wire code numpy can
express.  Frames the JAX package packs unpack in the port to equal
arrays (bfloat16 widened to float32 bit for bit, as the JAX array
upcasts), malformed headers raise ``PayloadError`` where JAX's do,
``stack_views`` gives the same batch and offsets, and the SRT1 dtype
table agrees with the C ABI of the port-built native library.
"""

import ctypes
import struct

import ml_dtypes
import numpy as np
import pytest

from seldon_core_tpu.codec import bufview as jax_bufview
from seldon_core_tpu.codec.tensor import PayloadError as JaxPayloadError
from seldon_core_tpu_torch import native
from seldon_core_tpu_torch.codec import BufferView, PayloadError, bufview, stack_views

NUMPY_CODES = [name for name in bufview.SRT1_DTYPES if name != "bfloat16"]


def _array(name: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    dt = np.dtype(name)
    if dt.kind == "f":
        return rng.standard_normal(shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, size=shape, dtype=dt, endpoint=True)


def test_dtype_table_matches_the_jax_package():
    assert bufview.SRT1_DTYPES == jax_bufview.SRT1_DTYPES
    assert bufview.SRT1_MAGIC == jax_bufview.SRT1_MAGIC
    assert (bufview.MAX_NDIM, bufview.MAX_ELEMS) == (jax_bufview.MAX_NDIM, jax_bufview.MAX_ELEMS)


@pytest.mark.parametrize("name", NUMPY_CODES)
@pytest.mark.parametrize("shape", [(3, 5), (7,), (), (2, 0, 3), (1, 2, 1, 3)])
def test_pack_frame_is_byte_equal_to_jax(name, shape):
    arr = _array(name, shape, seed=len(shape))
    assert bufview.pack_frame(arr) == jax_bufview.pack_frame(arr)
    back = bufview.unpack_frame(jax_bufview.pack_frame(arr))
    assert back.dtype == arr.dtype and back.shape == arr.shape
    np.testing.assert_array_equal(back.array(), arr)


def test_big_endian_and_strided_sources_match_jax():
    arr = np.arange(12, dtype=">i4").reshape(3, 4)
    assert bufview.pack_frame(arr) == jax_bufview.pack_frame(arr)
    strided = np.arange(40, dtype=np.float32).reshape(5, 8)[::2, 1::3]
    assert bufview.pack_frame(strided) == jax_bufview.pack_frame(strided)
    view = BufferView.from_array(strided)
    assert view.copied and not BufferView.from_array(np.ones(3)).copied


@pytest.mark.parametrize("rows", [[1, 2, 5], [3], [2, 2]])
def test_pack_frames_is_byte_equal_to_jax(rows):
    names = ["int8", "float16", "uint8", "float32", "int64"]
    arrays = [_array(names[i % len(names)], (r, 3), seed=i) for i, r in enumerate(rows)]
    packed = bufview.pack_frames(arrays)
    assert packed == jax_bufview.pack_frames(arrays)
    for a, v in zip(arrays, bufview.unpack_frames(jax_bufview.pack_frames(arrays))):
        np.testing.assert_array_equal(v.array(), a)
    # a trailing pad after the last frame is tolerated by both
    padded = packed + b"\x00" * (-len(packed) % 8)
    assert len(bufview.unpack_frames(padded)) == len(jax_bufview.unpack_frames(padded)) == len(rows)


@pytest.mark.parametrize("shape", [(4, 6), (9,), (2, 3, 5)])
def test_bfloat16_frames_widen_to_float32_bit_for_bit(shape):
    rng = np.random.default_rng(11)
    values = (rng.standard_normal(shape) * 100).astype(ml_dtypes.bfloat16)
    values.reshape(-1)[:4] = np.array([np.inf, -np.inf, np.nan, -0.0], dtype=ml_dtypes.bfloat16)[: values.size]
    frame = jax_bufview.pack_frame(values)
    view = bufview.unpack_frame(frame)
    got = view.array()
    assert view.wire == "bfloat16" and got.dtype == np.float32 and got.shape == shape
    want = values.astype(np.float32)
    assert got.tobytes() == want.tobytes()
    assert view.tobytes() == values.tobytes() and view.nbytes == values.nbytes
    # packing the widened array gives a float32 frame (code 0)
    assert bufview.pack_frame(view)[4] == 0
    # bf16 frames inside a container too
    both = jax_bufview.pack_frames([values, np.ones(3, np.int8)])
    assert bufview.unpack_frames(both)[0].array().tobytes() == want.tobytes()


def _malformed():
    good = jax_bufview.pack_frame(np.arange(10, dtype=np.int16).reshape(2, 5))
    huge = struct.pack("<IBBH", jax_bufview.SRT1_MAGIC, 0, 2, 0) + struct.pack("<2q", 1 << 32, 1 << 32)
    big_total = struct.pack("<IBBH", jax_bufview.SRT1_MAGIC, 1, 2, 0) + struct.pack("<2q", 1 << 20, 1 << 12)
    return {
        "truncated": good[:6],
        "bad_magic": b"SRTX" + good[4:],
        "unknown_code": good[:4] + bytes([99]) + good[5:],
        "ndim_over_8": good[:5] + bytes([9]) + good[6:],
        "truncated_shape": good[:12],
        "negative_dim": good[:8] + struct.pack("<q", -1) + good[16:],
        "dim_over_ceiling": huge,
        "elems_over_ceiling": big_total,
        "short_payload": good[:-2],
        "long_payload": good + b"\x00\x00",
    }


@pytest.mark.parametrize("case", sorted(_malformed()))
def test_malformed_frames_raise_where_jax_does(case):
    data = _malformed()[case]
    with pytest.raises(JaxPayloadError):
        jax_bufview.unpack_frame(data)
    with pytest.raises(PayloadError):
        bufview.unpack_frame(data)


def test_malformed_containers_raise_where_jax_does():
    a = jax_bufview.pack_frames([np.ones(3, np.int8), np.ones(2, np.float32)])
    dirty = a[:11] + b"\x01" + a[12:]  # non-zero inter-frame padding
    for data in (dirty, b"", a[:-3]):
        with pytest.raises(JaxPayloadError):
            jax_bufview.unpack_frames(data)
        with pytest.raises(PayloadError):
            bufview.unpack_frames(data)
    with pytest.raises(PayloadError):
        bufview.pack_frames([])
    with pytest.raises(PayloadError, match="no SRT1 wire code"):
        bufview.pack_frame(np.array(["a", "b"]))


def test_stack_views_matches_jax():
    rng = np.random.default_rng(5)
    arrays = [rng.integers(0, 256, (r, 12), dtype=np.uint8) for r in (1, 3, 2)]
    frames = [jax_bufview.pack_frame(a) for a in arrays]
    got, offsets = stack_views([bufview.unpack_frame(f) for f in frames])
    want, jax_offsets = jax_bufview.stack_views([jax_bufview.unpack_frame(f) for f in frames])
    assert offsets == jax_offsets == [0, 1, 4, 6]
    np.testing.assert_array_equal(got, want)
    lone = bufview.unpack_frame(frames[1])
    same, _ = stack_views([lone])
    assert np.shares_memory(same, lone.array())  # a lone view passes through uncopied
    with pytest.raises(PayloadError, match="does not stack"):
        stack_views([arrays[0], arrays[1].astype(np.int8)])


def test_views_are_zero_copy_and_read_through_asarray():
    body = bytearray(jax_bufview.pack_frame(np.arange(6, dtype=np.float32).reshape(2, 3)))
    view = bufview.unpack_frame(body)
    body[-4:] = np.float32(42.0).tobytes()  # the view aliases the buffer
    assert np.asarray(view)[1, 2] == 42.0 and len(view) == 2
    assert BufferView.from_bytes(bytes(8), "float32", (2,)).array().tolist() == [0.0, 0.0]
    with pytest.raises(PayloadError, match="misaligned"):
        BufferView.from_bytes(bytes(7), "float32", (2,))


def test_srt1_table_agrees_with_the_port_built_library():
    lib = native.get_lib()
    assert lib is not None, "the port's native library did not build (g++ and native/*.cc are needed)"
    assert lib.srt1_magic() == bufview.SRT1_MAGIC
    for code, name in enumerate(bufview.SRT1_DTYPES):
        item = 2 if name == "bfloat16" else np.dtype(name).itemsize
        assert lib.srt1_item_size(code) == item, name
    assert lib.srt1_item_size(len(bufview.SRT1_DTYPES)) == -1
    for ndim in range(9):
        assert lib.srt1_header_bytes(ndim) == 8 + 8 * ndim
    assert lib.srt1_header_bytes(9) == -1

    def c_payload_bytes(frame):
        buf = (ctypes.c_uint8 * len(frame)).from_buffer_copy(frame)
        return lib.srt1_payload_bytes(buf, len(frame))

    good = bufview.pack_frame(np.arange(10, dtype=np.int8).reshape(2, 5))
    assert c_payload_bytes(good) == 10
    for case, frame in _malformed().items():
        if case in ("short_payload", "long_payload"):
            continue  # srt1_payload_bytes sizes a frame; it does not check the buffer's end
        assert c_payload_bytes(frame) == -1, case

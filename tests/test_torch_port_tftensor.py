"""The port's ``tftensor`` codec against the JAX package's.

The same ``TensorProto`` messages decode through
``seldon_core_tpu.codec.tftensor`` and the port's copy, for every dtype
branch: dense ``tensor_content``, the typed ``*_val`` lists (with TF's
short-list padding), half and bfloat16 bit patterns in ``half_val``,
complex values and strings.  numpy has no bfloat16, so the port's
bfloat16 decode is held bit for bit against the JAX array upcast to
float32.  Encoding is held byte for byte, and whole ``SeldonMessage``s
carrying a ``tftensor`` round-trip through ``InternalMessage``.
"""

import ml_dtypes
import numpy as np
import pytest

from seldon_core_tpu.codec import tftensor as jax_tftensor
from seldon_core_tpu.runtime.message import InternalMessage as JaxMessage
from seldon_core_tpu_torch.codec import PayloadError, extract_json_payload, tftensor
from seldon_core_tpu_torch.proto import pb
from seldon_core_tpu_torch.proto import tf_compat_pb2 as tfpb
from seldon_core_tpu_torch.runtime.message import InternalMessage

VAL_CASES = {  # dtype -> (typed field, values)
    tfpb.DT_FLOAT: ("float_val", [1.5, -2.25, 3.0, 0.0, 7.5, -1.0]),
    tfpb.DT_DOUBLE: ("double_val", [1e-300, -2.5, 3.25, 4.0, 5.0, 6.0]),
    tfpb.DT_INT32: ("int_val", [-7, 0, 2147483647, -2147483648, 5, 6]),
    tfpb.DT_UINT8: ("int_val", [0, 255, 17, 3, 4, 5]),
    tfpb.DT_INT16: ("int_val", [-32768, 32767, 1, 2, 3, 4]),
    tfpb.DT_INT8: ("int_val", [-128, 127, 0, 1, 2, 3]),
    tfpb.DT_UINT16: ("int_val", [65535, 0, 1, 2, 3, 4]),
    tfpb.DT_INT64: ("int64_val", [-(2 ** 62), 2 ** 62, 1, 2, 3, 4]),
    tfpb.DT_UINT32: ("uint32_val", [4294967295, 0, 1, 2, 3, 4]),
    tfpb.DT_UINT64: ("uint64_val", [2 ** 63, 0, 1, 2, 3, 4]),
    tfpb.DT_BOOL: ("bool_val", [True, False, True, True, False, False]),
    tfpb.DT_HALF: ("half_val", np.array([1.0, -2.5, 65504.0, 0.0, np.inf, -0.0], np.float16)
                   .view(np.uint16).tolist()),
    tfpb.DT_BFLOAT16: ("half_val", np.array([1.0, -2.5, 3.0e38, 0.0, -np.inf, 1e-40], ml_dtypes.bfloat16)
                       .view(np.uint16).tolist()),
    tfpb.DT_COMPLEX64: ("scomplex_val", [1.0, 2.0, -3.0, 0.5, 0.0, 1.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0]),
    tfpb.DT_COMPLEX128: ("dcomplex_val", [1.0, 2.0, -3.0, 0.5, 0.0, 1.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0]),
    tfpb.DT_STRING: ("string_val", [b"a", b"bc", "é".encode(), b"", b"x", b"yz"]),
}


def _proto(dtype, shape, field=None, values=None, content=None):
    tp = tfpb.TensorProto(dtype=dtype)
    for d in shape:
        tp.tensor_shape.dim.add(size=d)
    if field is not None:
        getattr(tp, field).extend(values)
    if content is not None:
        tp.tensor_content = content
    return tp


def _as_comparable(jax_arr):
    """The JAX array as the port decodes it: bfloat16 upcast to float32."""
    if jax_arr.dtype == np.dtype(ml_dtypes.bfloat16):
        return jax_arr.astype(np.float32)
    return jax_arr


def _assert_same(got, want):
    want = _as_comparable(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == object:
        assert got.tolist() == want.tolist()
    else:
        assert got.tobytes() == want.tobytes()  # bit for bit, NaN and -0 included


@pytest.mark.parametrize("dtype", sorted(VAL_CASES), ids=lambda d: tfpb.DataType.Name(d))
@pytest.mark.parametrize("count", ["full", "short", "one", "empty"])
def test_typed_vals_decode_like_jax(dtype, count):
    field, values = VAL_CASES[dtype]
    per = 2 if field in ("scomplex_val", "dcomplex_val") else 1
    take = {"full": len(values), "short": 4 * per, "one": per, "empty": 0}[count]
    tp = _proto(dtype, (2, 3), field, values[:take])
    _assert_same(tftensor.tftensor_to_array(tp), jax_tftensor.tftensor_to_array(tp))


@pytest.mark.parametrize("dtype", sorted(d for d in VAL_CASES if d != tfpb.DT_STRING),
                         ids=lambda d: tfpb.DataType.Name(d))
def test_tensor_content_decodes_like_jax(dtype):
    want = jax_tftensor.tftensor_to_array(_proto(dtype, (2, 3), *VAL_CASES[dtype]))
    tp = _proto(dtype, (3, 2), content=np.ascontiguousarray(want).tobytes())
    _assert_same(tftensor.tftensor_to_array(tp), jax_tftensor.tftensor_to_array(tp))
    # tensor_content wins over a typed list
    both = _proto(dtype, (3, 2), *VAL_CASES[dtype], content=np.ascontiguousarray(want).tobytes())
    _assert_same(tftensor.tftensor_to_array(both), jax_tftensor.tftensor_to_array(both))


def test_scalars_decode_like_jax():
    for dtype, (field, values) in VAL_CASES.items():
        per = 2 if field in ("scomplex_val", "dcomplex_val") else 1
        tp = _proto(dtype, (), field, values[:per])
        _assert_same(tftensor.tftensor_to_array(tp), jax_tftensor.tftensor_to_array(tp))


@pytest.mark.parametrize("case", ["unknown_rank", "too_many_vals", "odd_complex", "string_content",
                                  "content_size", "unsupported_dtype"])
def test_refusals_match_jax(case):
    tp = {
        "unknown_rank": lambda: _proto(tfpb.DT_FLOAT, ()),
        "too_many_vals": lambda: _proto(tfpb.DT_INT32, (2,), "int_val", [1, 2, 3]),
        "odd_complex": lambda: _proto(tfpb.DT_COMPLEX64, (1,), "scomplex_val", [1.0, 2.0, 3.0]),
        "string_content": lambda: _proto(tfpb.DT_STRING, (1,), content=b"abc"),
        "content_size": lambda: _proto(tfpb.DT_FLOAT, (3,), content=np.ones(2, np.float32).tobytes()),
        "unsupported_dtype": lambda: _proto(tfpb.DT_RESOURCE, (1,), "int_val", [1]),
    }[case]()
    if case == "unknown_rank":
        tp.tensor_shape.unknown_rank = True
    with pytest.raises(jax_tftensor.TfTensorError):
        jax_tftensor.tftensor_to_array(tp)
    with pytest.raises(tftensor.TfTensorError):
        tftensor.tftensor_to_array(tp)


@pytest.mark.parametrize("arr", [
    np.arange(6, dtype=np.float32).reshape(2, 3), np.arange(4, dtype=np.int64), np.array([True, False]),
    np.array([1 + 2j, 3 - 1j], np.complex64), np.array([[1.5]], np.float16), np.arange(3, dtype=np.uint64),
    np.array([b"ab", b"c"], dtype=object), np.array(["x", "yz"]), np.zeros((0, 3), np.int8),
], ids=lambda a: f"{a.dtype}{a.shape}")
def test_encode_is_byte_equal_to_jax(arr):
    got = tftensor.array_to_tftensor(arr).SerializeToString()
    assert got == jax_tftensor.array_to_tftensor(arr).SerializeToString()
    back = tftensor.tftensor_to_array(tfpb.TensorProto.FromString(got))
    assert back.tolist() == (np.char.encode(arr).tolist() if arr.dtype.kind == "U" else arr.tolist())


def test_unencodable_dtype_is_refused_like_jax():
    arr = np.ones(2, np.dtype("datetime64[s]"))
    with pytest.raises(jax_tftensor.TfTensorError):
        jax_tftensor.array_to_tftensor(arr)
    with pytest.raises(tftensor.TfTensorError):
        tftensor.array_to_tftensor(arr)


@pytest.mark.parametrize("dtype", [tfpb.DT_FLOAT, tfpb.DT_BFLOAT16, tfpb.DT_STRING, tfpb.DT_INT8],
                         ids=lambda d: tfpb.DataType.Name(d))
def test_internal_message_round_trips_like_jax(dtype):
    msg = pb.SeldonMessage()
    msg.data.names.extend(["a", "b", "c"])
    msg.data.tftensor.CopyFrom(_proto(dtype, (2, 3), *VAL_CASES[dtype]))
    wire = msg.SerializeToString()
    port, ref = InternalMessage.from_proto(pb.SeldonMessage.FromString(wire)), JaxMessage.from_proto(
        pb.SeldonMessage.FromString(wire))
    assert port.kind == ref.kind == "tftensor" and port.names == ref.names
    _assert_same(port.payload, ref.payload)
    # the answer keeps the tftensor kind on the wire; JSON falls back like JAX's
    out = pb.SeldonMessage.FromString(port.to_proto().SerializeToString())
    assert out.data.WhichOneof("data_oneof") == "tftensor"
    if dtype == tfpb.DT_BFLOAT16:  # JAX re-encodes bf16; the port's widened array goes as DT_FLOAT
        assert out.data.tftensor.dtype == tfpb.DT_FLOAT
        _assert_same(tftensor.tftensor_to_array(out.data.tftensor), ref.payload)
    else:
        assert out.SerializeToString() == pb.SeldonMessage.FromString(
            ref.to_proto().SerializeToString()).SerializeToString()
        assert port.to_json() == ref.to_json()


def test_json_tftensor_body_is_refused_like_jax():
    from seldon_core_tpu.codec import extract_json_payload as jax_extract
    from seldon_core_tpu.codec.tensor import PayloadError as JaxPayloadError

    body = {"data": {"tftensor": {"dtype": "DT_FLOAT", "floatVal": [1.0]}}}
    with pytest.raises(JaxPayloadError) as want:
        jax_extract(body)
    with pytest.raises(PayloadError) as got:
        extract_json_payload(body)
    assert str(got.value) == str(want.value)

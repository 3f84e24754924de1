"""bfloat16 and the narrow ml_dtypes on the wire: the port's codec against
the JAX package's.

The JAX codec resolves ``bfloat16`` and the float8 / float6 / float4 and
int4 / int2 names through ``ml_dtypes`` and keeps the payload in that
type; the port (no ``ml_dtypes``) reads the same bytes as uint16 or uint8
and widens them to float32 (int8 / uint8 for the integers).  Widening is
exact, so the port's array equals the JAX array upcast bit for bit, and a
served model sees the values a float32 request would carry.
"""

import asyncio
import base64

import ml_dtypes
import numpy as np
import pytest

from seldon_core_tpu.codec import tensor as jax_tensor
from seldon_core_tpu.proto import pb as jax_pb
from seldon_core_tpu_torch.codec import PayloadError, extract_json_payload, raw_tensor_to_array
from seldon_core_tpu_torch.models.cudaserver import CudaServer
from seldon_core_tpu_torch.proto import pb
from seldon_core_tpu_torch.runtime import rest

SHAPE = (32, 32, 3)


def _bf16_values(shape, seed):
    """Random bf16 values with the edge cases in front: signed zeros,
    infinities, the smallest subnormal and the largest finite value."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(int(np.prod(shape))) * 10.0 ** rng.integers(-6, 6, int(np.prod(shape)))).astype(np.float32)
    x[:6] = [0.0, -0.0, np.inf, -np.inf, 2.0 ** -133, 3.3895314e38]
    return x.astype(ml_dtypes.bfloat16).reshape(shape)


def _raw_json(arr, dtype=None):
    return {"data": {"rawTensor": {"shape": list(arr.shape), "dtype": dtype or arr.dtype.name,
                                   "data": base64.b64encode(arr.tobytes()).decode("ascii")}}}


@pytest.mark.parametrize("shape", [(7,), (2, 3, 5), (1, 32, 32, 3)])
def test_bf16_raw_tensor_equals_the_jax_codec_bit_for_bit(shape):
    x = _bf16_values(shape, seed=sum(shape))
    ref = jax_tensor.raw_tensor_to_array(jax_pb.RawTensor(shape=list(shape), dtype="bfloat16", data=x.tobytes()))
    assert ref.dtype == ml_dtypes.bfloat16
    ref32 = ref.astype(np.float32)
    got = raw_tensor_to_array(pb.RawTensor(shape=list(shape), dtype="bfloat16", data=x.tobytes()))
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), ref32.view(np.uint32))
    got_json, _, _, kind = extract_json_payload(_raw_json(x))  # the REST path's decoder
    assert kind == "rawTensor"
    np.testing.assert_array_equal(got_json.view(np.uint32), ref32.view(np.uint32))


def test_bf16_payload_errors_name_the_wire_dtype():
    with pytest.raises(PayloadError, match="multiple of bfloat16 itemsize 2"):
        raw_tensor_to_array(pb.RawTensor(shape=[2], dtype="bfloat16", data=b"\x00\x01\x02"))
    with pytest.raises(PayloadError, match="needs 3 bfloat16 elements"):
        raw_tensor_to_array(pb.RawTensor(shape=[3], dtype="bfloat16", data=b"\x00" * 4))


# the narrow ml_dtypes names the JAX codec resolves, with their widths in bits
NARROW_DTYPES = {
    "float8_e4m3fn": 8, "float8_e5m2": 8, "float8_e4m3fnuz": 8, "float8_e5m2fnuz": 8, "float8_e4m3b11fnuz": 8,
    "float8_e3m4": 8, "float8_e4m3": 8, "float8_e8m0fnu": 8, "float6_e2m3fn": 6, "float6_e3m2fn": 6,
    "float4_e2m1fn": 4, "int4": 4, "uint4": 4, "int2": 2, "uint2": 2,
}


@pytest.mark.parametrize("name", sorted(NARROW_DTYPES))
def test_narrow_ml_dtypes_widen_like_the_jax_codec(name):
    """Every code of the format (NaN codes included), as ml_dtypes writes
    it into a rawTensor, decodes to the JAX codec's array upcast: equal
    values, NaN at the same places, equal signed zeros."""
    dtype = np.dtype(getattr(ml_dtypes, name))
    codes = np.arange(1 << NARROW_DTYPES[name], dtype=np.uint8)
    x = codes.view(dtype).reshape(-1, 2) if codes.size > 2 else codes.view(dtype)
    data = x.tobytes()
    is_float = name.startswith("float")
    wide = np.float32 if is_float else (np.int8 if name.startswith("int") else np.uint8)
    if is_float:  # ml_dtypes writes each finite value back as its code
        values = x.astype(np.float32)
        finite = ~np.isnan(values)
        np.testing.assert_array_equal(values[finite].astype(dtype).view(np.uint8), x.view(np.uint8)[finite])
    ref = jax_tensor.raw_tensor_to_array(jax_pb.RawTensor(shape=list(x.shape), dtype=name, data=data)).astype(wide)
    got = raw_tensor_to_array(pb.RawTensor(shape=list(x.shape), dtype=name, data=data))
    got_json, _, _, kind = extract_json_payload(_raw_json(x, dtype=name))  # the REST path's decoder
    assert kind == "rawTensor"
    for arr in (got, got_json):
        assert arr.dtype == wide and arr.shape == x.shape
        if is_float:
            np.testing.assert_array_equal(np.isnan(arr), np.isnan(ref))
            np.testing.assert_array_equal(arr.view(np.uint32)[~np.isnan(ref)], ref.view(np.uint32)[~np.isnan(ref)])
        else:
            np.testing.assert_array_equal(arr, ref)


def test_cuda_server_answers_bf16_as_the_same_values_in_f32():
    cs = CudaServer(device="cpu", model="resnet_tiny", num_classes=5, dtype="float32", normalize=True,
                    max_batch_size=2, warmup=False, seed=4)
    cs.load()
    x = (np.random.default_rng(2).standard_normal((2, *SHAPE)) * 64).astype(ml_dtypes.bfloat16)

    async def post_both():
        from aiohttp.test_utils import TestClient, TestServer

        client = TestClient(TestServer(rest.build_app(cs)))
        await client.start_server()
        try:
            out = []
            for body in (_raw_json(x), _raw_json(x.astype(np.float32))):
                resp = await client.post("/predict", json=body)
                out.append((resp.status, await resp.json()))
            return out
        finally:
            await client.close()

    try:
        (status_bf16, body_bf16), (status_f32, body_f32) = asyncio.run(post_both())
    finally:
        cs.unload()
    assert status_bf16 == status_f32 == 200

    def logits(body):
        r = body["data"]["rawTensor"]
        return np.frombuffer(base64.b64decode(r["data"]), dtype=r["dtype"]).reshape(r["shape"])

    got, ref = logits(body_bf16), logits(body_f32)
    assert got.shape == (2, 5) and np.isfinite(got).all()
    # the same float32 batch at the same batch shape: the same arithmetic
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)

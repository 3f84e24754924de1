"""The port's ``CudaServer`` serving the transformer families against ``JaxServer``.

A CPU ``CudaServer`` and a ``JaxServer`` with the same kwargs serve the
same flax variables (the JAX package's own init, converted for the port
by family): ``vit_tiny`` with ``{"attention": "flash"}`` on uint8 images
with ``normalize=true``, ``transformer_encoder`` and ``transformer_lm``
on token ids.  The JAX side runs its Pallas kernels in interpret mode,
the port's its plain versions.  Parameter errors are compared by status
and reason.

Tolerance: float32 servers, same weights: rtol = atol = 1e-4 (summation
order only).  Batch shapes differ between calls, so nothing is compared
bit for bit.
"""

import asyncio
import base64

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_core_tpu.models.jaxserver import JaxServer
from seldon_core_tpu.models.transformer import TransformerEncoder as FlaxTransformerEncoder
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu.models.vit import ViTTiny as FlaxViTTiny
from seldon_core_tpu.runtime import MicroserviceError as JaxMicroserviceError
from seldon_core_tpu.runtime import rest as jax_rest
from seldon_core_tpu_torch.models.cudaserver import CudaServer
from seldon_core_tpu_torch.ops import kernels
from seldon_core_tpu_torch.runtime import MicroserviceError, rest

TOL = dict(rtol=1e-4, atol=1e-4)
NUM_CLASSES = 10
SHAPE = (32, 32, 3)
FLASH = {"attention": "flash"}


def _pair(variables, **common):
    js = JaxServer(**common)
    js.load()
    js.variables = jax.device_put(variables)
    cs = CudaServer(device="cpu", variables=variables, **common)
    cs.load()
    return js, cs


@pytest.fixture(scope="module")
def vit_servers():
    variables = FlaxViTTiny(num_classes=NUM_CLASSES, dtype=jnp.float32).init(
        jax.random.key(5), jnp.zeros((1, *SHAPE), jnp.float32))
    js, cs = _pair(variables, model="vit_tiny", num_classes=NUM_CLASSES, dtype="float32", normalize=True,
                   max_batch_size=4, warmup=False, model_kwargs=FLASH)
    yield js, cs
    js.unload()
    cs.unload()


def _images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, *SHAPE), dtype=np.uint8)


class TestViTTinyFlash:
    def test_uint8_input_normalized_same_rows(self, vit_servers):
        js, cs = vit_servers
        x = _images(3, seed=1)
        got = cs.predict(x, [])
        assert got.shape == (3, NUM_CLASSES) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(js.predict(x, [])), **TOL)
        # the same pixels as float skip normalization in both, and answer differently
        xf = x.astype(np.float32)
        got_f = cs.predict(xf, [])
        np.testing.assert_allclose(got_f, np.asarray(js.predict(xf, [])), **TOL)
        assert np.abs(got_f - got).max() > 1e-2

    def test_server_wires_flash_into_every_block(self, vit_servers):
        _, cs = vit_servers
        assert all(b.attn_fn.__qualname__.startswith("flash_attn_fn") for b in cs.module.blocks)
        assert not any(b.causal for b in cs.module.blocks)
        assert "flash_attention" in cs.health_status()["kernel_launches"]

    def test_rest_raw_tensor(self, vit_servers):
        x = _images(2, seed=2)
        body = {"data": {"rawTensor": {"shape": list(x.shape), "dtype": "uint8",
                                       "data": base64.b64encode(x.tobytes()).decode("ascii")}}}

        async def scenario():
            from aiohttp.test_utils import TestClient, TestServer

            out = []
            for app in (jax_rest.build_app(vit_servers[0]), rest.build_app(vit_servers[1])):
                client = TestClient(TestServer(app))
                await client.start_server()
                try:
                    resp = await client.post("/predict", json=body)
                    out.append((resp.status, await resp.json()))
                finally:
                    await client.close()
            return out

        (js_status, js_body), (status, port_body) = asyncio.run(scenario())
        assert js_status == status == 200

        def decode(b):
            r = b["data"]["rawTensor"]
            return np.frombuffer(base64.b64decode(r["data"]), dtype=r["dtype"]).reshape(r["shape"])

        np.testing.assert_allclose(decode(port_body), decode(js_body), **TOL)


def _refused_both(**kwargs):
    js = JaxServer(**kwargs)
    with pytest.raises(JaxMicroserviceError) as jax_err:
        js.load()
    cs = CudaServer(device="cpu", **kwargs)
    with pytest.raises(MicroserviceError) as port_err:
        cs.load()
    assert port_err.value.to_status() == jax_err.value.to_status()
    return port_err.value


class TestParameterErrors:
    def test_bad_attention(self):
        err = _refused_both(model="vit_tiny", num_classes=3, dtype="float32", warmup=False,
                            model_kwargs={"attention": "ring"})
        assert err.reason == "BAD_ATTENTION" and err.status_code == 400

    @pytest.mark.parametrize("model", ["transformer_encoder", "transformer_lm"])
    def test_missing_input_shape(self, model):
        err = _refused_both(model=model, num_classes=3, dtype="float32", warmup=False,
                            model_kwargs={"vocab_size": 16, "d_model": 16, "num_layers": 1, "num_heads": 2,
                                          "max_len": 16})
        assert err.reason == "MISSING_INPUT_SHAPE" and err.status_code == 400


TOKEN_KW = {"vocab_size": 64, "d_model": 32, "num_layers": 2, "num_heads": 2, "max_len": 32}


@pytest.mark.parametrize("model", ["transformer_encoder", "transformer_lm"])
def test_token_families_with_flash_match_jax_server(model):
    if model == "transformer_encoder":
        fmod = FlaxTransformerEncoder(num_classes=3, dtype=jnp.float32, **TOKEN_KW)
    else:
        fmod = FlaxTransformerLM(dtype=jnp.float32, **TOKEN_KW)
    variables = fmod.init(jax.random.key(6), jnp.zeros((1, 24), jnp.int32))
    js, cs = _pair(variables, model=model, num_classes=3, input_shape=(24,), dtype="float32", max_batch_size=2,
                   warmup=False, warmup_dtypes=("int32",), model_kwargs={**TOKEN_KW, **FLASH})
    tokens = np.random.default_rng(7).integers(0, 64, (2, 24)).astype(np.int32)
    try:
        before = kernels.launch_counts()
        got, ref = cs.predict(tokens, []), np.asarray(js.predict(tokens, []))
        assert kernels.launch_counts() == before  # the CPU server takes the plain versions
    finally:
        js.unload()
        cs.unload()
    assert got.shape == ref.shape == ((2, 3) if model == "transformer_encoder" else (2, 24, 64))
    assert all(b.causal == (model == "transformer_lm") for b in cs.module.blocks)
    np.testing.assert_allclose(got, ref, **TOL)


def test_seeded_vit_server_is_deterministic():
    outs = []
    for _ in range(2):
        cs = CudaServer(device="cpu", model="vit_tiny", num_classes=4, dtype="float32", max_batch_size=2,
                        normalize=True, warmup=False, seed=3, model_kwargs=FLASH)
        cs.load()
        try:
            outs.append(cs.predict(_images(2, seed=8), []))
        finally:
            cs.unload()
    assert np.isfinite(outs[0]).all() and np.abs(outs[0]).max() > 0
    np.testing.assert_array_equal(outs[0], outs[1])

"""The port's non-paged generation lane against the JAX package's.

The same numpy-drawn flax ``TransformerLM`` parameters (carried across by
``lm_params_from_flax``) and the same prompts go through the JAX
``TransformerLM(decode=True)`` / ``Generator`` / ``GenerativeLM`` and the
port's cached ``TransformerLM.forward(..., cache=)`` / ``Generator`` /
``GenerativeLM`` on the CPU.

Tolerances: float32 logits within atol 1e-5 (summation order differs
between XLA and PyTorch on the CPU); float32 greedy ids exactly equal, in
native and int8 weights; bfloat16 ids: the first token equal and at
least 0.75 of all tokens (the two frameworks round bf16 at different
places, so a near-tie may fall the other way and the rows then diverge).
Sampled ids are not compared with JAX's (``torch.Generator`` draws, not
``jax.random``): a seed repeats its draw, seeds differ, and no draw
leaves the top-k set.
"""

import asyncio
import threading
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import generate as jax_generate
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu.runtime.component import MicroserviceError as JaxMicroserviceError
from seldon_core_tpu_torch.engine import units
from seldon_core_tpu_torch.models import generate
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine
from seldon_core_tpu_torch.models.transformer import TransformerLM
from seldon_core_tpu_torch.ops import surgery
from seldon_core_tpu_torch.runtime.component import MicroserviceError

CFG = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4, max_len=64)
# the mesh generator's config: wide enough that every block kernel
# reaches the sharding rule's 16,384 elements, so both packages shard
# the same leaves at their defaults
MESH_CFG = dict(CFG, d_model=128)
F32_ATOL = 1e-5
BF16_MIN_SHARE = 0.75
PROMPT = np.array([[5, 9, 13, 2, 30]], np.int32)


def _numpy_params(seed, cfg=CFG):
    """The flax tree's structure, every leaf drawn from numpy: kernels
    LeCun-normal, embeddings normal / sqrt(d), biases small, LayerNorm
    scales in [0.5, 1.5]."""
    shapes = jax.eval_shape(FlaxTransformerLM(dtype=jnp.float32, **cfg).init, jax.random.key(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        shape, name = tuple(x.shape), path[-1].key
        if name == "kernel":
            return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
        if name == "embedding":
            return (rng.standard_normal(shape) / np.sqrt(shape[1])).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        raise KeyError(name)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def flax_params():
    return _numpy_params(seed=19)


@pytest.fixture(scope="module")
def params(flax_params):
    return lm_params_from_flax(flax_params)


def _port(params, dtype=torch.float32, **kw):
    return generate.Generator(params, dtype=dtype, device="cpu", **CFG, **kw)


def _greedy_uncached(params, prompt, n):
    """Reference decoder: the port's full forward every step, argmax."""
    lm = TransformerLM(dtype=torch.float32, **CFG)
    lm.load_state_dict(params)
    tokens = torch.from_numpy(np.asarray(prompt, np.int64))
    out = []
    with torch.no_grad():
        for _ in range(n):
            nxt = int(torch.argmax(lm(tokens)[0, -1]))
            out.append(nxt)
            tokens = torch.cat([tokens, torch.tensor([[nxt]])], dim=1)
    return out


class TestDecodeCache:
    def test_cached_prefill_and_step_logits_match_jax(self, flax_params, params):
        rng = np.random.default_rng(3)
        tokens = rng.integers(0, CFG["vocab_size"], size=(2, 16)).astype(np.int32)
        step = rng.integers(0, CFG["vocab_size"], size=(2, 1)).astype(np.int32)
        jmod = FlaxTransformerLM(dtype=jnp.float32, decode=True, **CFG)
        jcache = jax_generate.Generator(flax_params, dtype=jnp.float32, **CFG)._init_cache(2)
        jlog, mutated = jmod.apply({"params": flax_params, "cache": jcache}, jnp.asarray(tokens),
                                   positions=jnp.arange(16), mutable=["cache"])
        jstep, _ = jmod.apply({"params": flax_params, "cache": mutated["cache"]}, jnp.asarray(step),
                              positions=jnp.array([16]), mutable=["cache"])

        lm = TransformerLM(dtype=torch.float32, **CFG)
        lm.load_state_dict(params)
        cache = lm.init_cache(2)
        with torch.no_grad():
            got = lm(torch.from_numpy(tokens), torch.arange(16), cache=cache)
            assert cache.index == 16
            got_step = lm(torch.from_numpy(step), torch.tensor([16]), cache=cache)
        assert cache.index == 17
        np.testing.assert_allclose(got.numpy(), np.asarray(jlog), rtol=0, atol=F32_ATOL)
        np.testing.assert_allclose(got_step.numpy(), np.asarray(jstep), rtol=0, atol=F32_ATOL)
        # the non-cached forward is the same function
        with torch.no_grad():
            np.testing.assert_allclose(lm(torch.from_numpy(tokens)).numpy(), got.numpy(), rtol=0, atol=F32_ATOL)

    def test_cache_shape_dtype_and_bytes(self, params):
        lm = TransformerLM(dtype=torch.bfloat16, **CFG)
        lm.load_state_dict(params)
        cache = lm.init_cache(3)
        hd = CFG["d_model"] // CFG["num_heads"]
        assert len(cache.keys) == len(cache.values) == CFG["num_layers"]
        assert all(t.shape == (3, CFG["max_len"], CFG["num_heads"], hd) and t.dtype == torch.bfloat16
                   for t in (*cache.keys, *cache.values))
        assert cache.nbytes == 2 * CFG["num_layers"] * 3 * CFG["max_len"] * CFG["d_model"] * 2


class TestGenerator:
    @pytest.mark.parametrize("quantize", ["", "int8"])
    def test_f32_greedy_equals_recompute_and_jax(self, flax_params, params, quantize):
        prompts = np.array([[5, 9, 13, 2, 30], [1, 2, 3, 4, 5]], np.int32)
        got = _port(params, quantize=quantize).generate(prompts, max_new_tokens=12)
        want = jax_generate.Generator(flax_params, dtype=jnp.float32, quantize=quantize, **CFG).generate(
            prompts, max_new_tokens=12)
        assert got.dtype == np.int32 and got.shape == (2, 12)
        np.testing.assert_array_equal(got, np.asarray(want))
        if not quantize:
            assert got[0].tolist() == _greedy_uncached(params, prompts[:1], 12)

    def test_int8_dequantises_once_per_call(self, params, monkeypatch):
        gen = _port(params, quantize="int8")
        calls = []
        real = surgery.QuantizedKernel.dequantize
        monkeypatch.setattr(surgery.QuantizedKernel, "dequantize",
                            lambda self, dtype: calls.append(1) or real(self, dtype))
        gen.generate(PROMPT, max_new_tokens=9)
        assert len(calls) == len(gen.quantize_manifest) > 0

    def test_bf16_ids_agree_with_jax(self, flax_params, params):
        rng = np.random.default_rng(7)
        prompts = rng.integers(0, CFG["vocab_size"], size=(4, 9)).astype(np.int32)
        got = _port(params, dtype=torch.bfloat16).generate(prompts, max_new_tokens=16)
        want = np.asarray(jax_generate.Generator(flax_params, **CFG).generate(prompts, max_new_tokens=16))
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        assert (got == want).mean() >= BF16_MIN_SHARE

    def test_batched_rows_equal_their_solo_runs(self, params):
        gen = _port(params)
        prompts = np.array([[1, 2, 3], [7, 8, 9]], np.int32)
        out = gen.generate(prompts, max_new_tokens=4)
        assert out.shape == (2, 4)
        for i in range(2):
            np.testing.assert_array_equal(out[i], gen.generate(prompts[i:i + 1], max_new_tokens=4)[0])

    def test_eos_freezes_finished_rows(self, flax_params, params):
        first = _greedy_uncached(params, PROMPT, 1)[0]
        out = _port(params).generate(PROMPT, max_new_tokens=6, eos_id=first)[0]
        assert out[0] == first and (out[1:] == first).all()
        want = jax_generate.Generator(flax_params, dtype=jnp.float32, **CFG).generate(PROMPT, max_new_tokens=6,
                                                                                      eos_id=first)
        np.testing.assert_array_equal(out, np.asarray(want)[0])

    def test_shape_keys_are_recorded_per_bucket(self, params):
        gen = _port(params, prompt_buckets=[8, 16])
        gen.generate(np.array([[1, 2, 3]], np.int32), max_new_tokens=2)
        gen.generate(np.array([[4, 5, 6, 7, 1]], np.int32), max_new_tokens=2)
        assert gen.programs == {(1, 8, 2)}  # both prompts pad to bucket 8
        gen.generate(np.arange(12, dtype=np.int32)[None], max_new_tokens=3)
        assert gen.programs == {(1, 8, 2), (1, 16, 4)}

    def test_exact_count_retry_serves(self, flax_params, params):
        # 40 + its power-of-two bucket (32) overflows 64, 40 + 20 fits
        prompt = np.arange(40, dtype=np.int32)[None] % CFG["vocab_size"]
        gen = _port(params)
        got = gen.generate(prompt, max_new_tokens=20)
        assert gen.programs == {(1, 64, 20)}
        want = jax_generate.Generator(flax_params, dtype=jnp.float32, **CFG).generate(prompt, max_new_tokens=20)
        np.testing.assert_array_equal(got, np.asarray(want))

    @pytest.mark.parametrize("plen,max_new", [(60, 30), (70, 1), (5, 0), (5, -3)])
    def test_refusals_match_jax(self, flax_params, params, plen, max_new):
        prompt = np.zeros((1, plen), np.int32)
        with pytest.raises(JaxMicroserviceError) as jerr:
            jax_generate.Generator(flax_params, dtype=jnp.float32, **CFG).generate(prompt, max_new_tokens=max_new)
        with pytest.raises(MicroserviceError) as err:
            _port(params).generate(prompt, max_new_tokens=max_new)
        assert str(err.value) == str(jerr.value)
        assert (err.value.reason, err.value.status_code) == (jerr.value.reason, jerr.value.status_code)
        assert err.value.reason in ("SEQUENCE_TOO_LONG", "BAD_REQUEST")

    def test_sampling_is_seeded_and_varies(self, params):
        gen = _port(params)
        a = gen.generate(PROMPT, max_new_tokens=8, temperature=1.5, seed=1)
        b = gen.generate(PROMPT, max_new_tokens=8, temperature=1.5, seed=1)
        c = gen.generate(PROMPT, max_new_tokens=8, temperature=1.5, seed=2)
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)

    def test_top_k_one_is_greedy(self, flax_params, params):
        hot = _port(params).generate(PROMPT, max_new_tokens=5, temperature=2.0, top_k=1, seed=3)[0]
        want = jax_generate.Generator(flax_params, dtype=jnp.float32, **CFG).generate(PROMPT, max_new_tokens=5,
                                                                                      temperature=2.0, top_k=1,
                                                                                      seed=3)
        assert hot.tolist() == np.asarray(want)[0].tolist() == _greedy_uncached(params, PROMPT, 5)

    def test_draws_stay_in_the_top_k(self, params):
        lm = TransformerLM(dtype=torch.float32, **CFG)
        lm.load_state_dict(params)
        gen = _port(params)
        for seed in range(4):
            out = gen.generate(PROMPT, max_new_tokens=6, temperature=5.0, top_k=3, seed=seed)[0]
            tokens = torch.from_numpy(PROMPT.astype(np.int64))
            with torch.no_grad():
                for t in out:
                    logits = lm(tokens)[0, -1]
                    assert logits[int(t)] >= torch.topk(logits, 3).values[-1]
                    tokens = torch.cat([tokens, torch.tensor([[int(t)]])], dim=1)

    def test_concurrent_calls_own_their_caches(self, params):
        gen = _port(params)
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, CFG["vocab_size"], size=(1, n)).astype(np.int32) for n in (3, 9, 17, 5)]
        want = [gen.generate(p, max_new_tokens=8) for p in prompts]
        got = [None] * len(prompts)

        def run(i):
            got[i] = gen.generate(prompts[i], max_new_tokens=8)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_tp_dp_degrade_and_a_2x2_mesh_decodes_jax_s_tokens(self, params, flax_params, monkeypatch):
        """Once refused as the engine refused meshes; both landed (A12).
        ``tp`` / ``dp`` degrade as the engine's do (distinct CUDA devices);
        an explicit mesh of CPU positions (dp 2, tp 2) decodes the JAX
        generator's greedy tokens on its mesh and the one-device port's,
        at a width where both shard the same leaves by default."""
        from seldon_core_tpu.parallel import create_mesh as jax_create_mesh
        from seldon_core_tpu_torch.parallel import P, create_mesh

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        want = _port(params).generate(PROMPT, max_new_tokens=8)
        for kw in (dict(tp=2), dict(dp=2)):
            gen = _port(params, **kw)
            assert (gen.tp_degree, gen.dp_degree) == (1, 1)
            assert (PagedEngine(params, dtype="float32", device="cpu", **CFG, **kw).tp_degree, gen.tp_degree) == (1, 1)
            np.testing.assert_array_equal(gen.generate(PROMPT, max_new_tokens=8), want)
        mesh_flax = _numpy_params(seed=23, cfg=MESH_CFG)
        mesh_params = lm_params_from_flax(mesh_flax)
        mesh = create_mesh({"data": 2, "model": 2}, devices=["cpu"] * 4)
        gen = generate.Generator(mesh_params, dtype=torch.float32, mesh=mesh, **MESH_CFG)
        assert (gen.tp_degree, gen.dp_degree) == (2, 2)
        assert gen.module.specs["blocks.0.attn_proj.weight"] != P()  # the block kernels shard
        prompts = np.concatenate([PROMPT, PROMPT[:, ::-1]])
        got = gen.generate(prompts, max_new_tokens=8)
        jmesh = jax_create_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
        jgot = jax_generate.Generator(mesh_flax, dtype=jnp.float32, mesh=jmesh, **MESH_CFG).generate(
            prompts, max_new_tokens=8)
        np.testing.assert_array_equal(got, np.asarray(jgot))
        one = generate.Generator(mesh_params, dtype=torch.float32, device="cpu", **MESH_CFG)
        np.testing.assert_array_equal(got, one.generate(prompts, max_new_tokens=8))

    def test_cuda_without_a_card_raises(self, params, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(MicroserviceError) as err:
            generate.Generator(params, **CFG)
        assert err.value.reason == "NO_CUDA_DEVICE"


class TestGenerativeLM:
    def test_serves_token_ids(self):
        comp = generate.GenerativeLM(max_new_tokens=4, seed=0, device="cpu", **CFG)
        comp.load()
        out = comp.predict(np.array([[3, 1, 4]], np.int32), [])
        assert out.shape == (1, 4) and np.issubdtype(out.dtype, np.integer)
        assert (out >= 0).all() and (out < CFG["vocab_size"]).all()
        assert comp.generator.dtype == torch.bfloat16
        assert comp.class_names() == []
        assert generate.GenerativeLM.device_exclusive is True

    def test_load_is_idempotent(self):
        comp = generate.GenerativeLM(device="cpu", **CFG)
        comp.load()
        first = comp.generator
        comp.load()
        assert comp.generator is first

    @pytest.mark.parametrize("meta", [
        {"tags": {"seed": 17, "max_new_tokens": 6, "temperature": 0.5, "top_k": 3}},
        {"puid": "abc-123"},
        {"puid": "abc-123", "tags": {"max_new_tokens": 2}},
        None,
    ])
    def test_seed_and_tag_overrides_match_jax(self, meta):
        def calls(component):
            seen = []

            class Recorder:
                def generate(self, X, **kw):
                    seen.append(kw)
                    return np.zeros((1, kw["max_new_tokens"]), np.int32)

            component.generator = Recorder()
            for _ in range(2):
                component.predict(np.array([[1, 2]], np.int32), [], meta=meta)
            return seen

        kw = dict(seed=5, max_new_tokens=4, temperature=0.0, top_k=0, eos_id=9)
        got = calls(generate.GenerativeLM(device="cpu", **kw, **CFG))
        want = calls(jax_generate.GenerativeLM(**kw, **CFG))
        assert got == want
        if meta and "seed" in meta.get("tags", {}):
            assert got[0]["seed"] == 5 ^ 17
        elif meta and "puid" in meta:
            assert got[0]["seed"] == 5 ^ zlib.crc32(b"abc-123")
        else:
            assert [c["seed"] for c in got] == [5 ^ 1, 5 ^ 2]

    def test_quantize_validated_at_construction(self):
        with pytest.raises(ValueError):
            generate.GenerativeLM(quantize="int4", device="cpu", **CFG)

    def test_tp_and_mesh_axes_load_and_serve(self, monkeypatch):
        """Once refused at load (A12 landed): ``tp=2`` loads, degraded to
        one device on a host without two CUDA devices, and ``mesh_axes``
        lays a CPU component over that many CPU positions; both serve."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        comp = generate.GenerativeLM(tp=2, device="cpu", max_new_tokens=3, **CFG)
        comp.load()
        assert comp.health_status()["tp_degree"] == 1
        meshed = generate.GenerativeLM(mesh_axes={"model": 2}, device="cpu", max_new_tokens=3, **CFG)
        meshed.load()
        assert (meshed.generator.tp_degree, meshed.health_status()["tp_degree"]) == (2, 2)
        out = meshed.predict(PROMPT, [])
        assert out.shape == (1, 3) and out.dtype == np.int32

    def test_graph_registry_resolves_generative_lm(self):
        assert units._lookup_builtin("GENERATIVE_LM") is generate.GenerativeLM
        assert units._lookup_builtin("generative_lm") is generate.GenerativeLM

    def test_serves_by_name_through_the_graph(self):
        from seldon_core_tpu_torch.engine import PredictorService, UnitSpec
        from seldon_core_tpu_torch.runtime.message import InternalMessage

        params = [{"name": k, "value": str(v), "type": "INT"} for k, v in CFG.items()]
        params += [{"name": "max_new_tokens", "value": "5", "type": "INT"},
                   {"name": "device", "value": "cpu", "type": "STRING"}]
        svc = PredictorService(UnitSpec.from_dict({"name": "lm", "type": "MODEL", "implementation": "GENERATIVE_LM",
                                                   "parameters": params}))
        prompts = np.array([[3, 1, 4, 1], [5, 9, 2, 6]], np.float64)
        out = asyncio.run(svc.predict(InternalMessage(payload=prompts, kind="ndarray")))
        assert out.status["status"] == "SUCCESS" and out.meta.request_path == {"lm": "GENERATIVE_LM"}
        ids = np.asarray(out.payload)
        component = svc.executor.component("lm")
        assert ids.shape == (2, 5)
        np.testing.assert_array_equal(ids, component.generator.generate(prompts, max_new_tokens=5))
        assert component.health_status()["programs"] == [(2, 16, 8)]

    def test_rest_answer_has_jax_components_shape(self):
        from aiohttp.test_utils import TestClient, TestServer

        from seldon_core_tpu.runtime import rest as jax_rest
        from seldon_core_tpu_torch.runtime import rest

        body = {"data": {"ndarray": [[3, 1, 4], [1, 5, 9]]}, "meta": {"tags": {"max_new_tokens": 3}}}
        comps = [jax_generate.GenerativeLM(max_new_tokens=4, **CFG),
                 generate.GenerativeLM(max_new_tokens=4, device="cpu", **CFG)]

        async def post_both():
            out = []
            for app in (jax_rest.build_app(comps[0]), rest.build_app(comps[1])):
                client = TestClient(TestServer(app))
                await client.start_server()
                try:
                    resp = await client.post("/predict", json=body)
                    out.append((resp.status, await resp.json()))
                finally:
                    await client.close()
            return out

        (js, jbody), (status, pbody) = asyncio.run(post_both())
        assert js == status == 200
        assert set(pbody["data"]) == set(jbody["data"]) == {"ndarray"}  # class_names() is [], so no names
        assert pbody["meta"]["tags"] == jbody["meta"]["tags"]
        ids = np.asarray(pbody["data"]["ndarray"])
        assert ids.shape == np.asarray(jbody["data"]["ndarray"]).shape == (2, 3)
        assert ((ids >= 0) & (ids < CFG["vocab_size"])).all()

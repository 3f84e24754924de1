"""The paged engine, the speculative lanes and the Generator on a serving
mesh, against the JAX package's mesh engines and the port's one-device
engine (``parallel/tp.py``, ``models/paged.py``).

Meshes are explicit CPU positions (the JAX side runs on conftest's host
devices).  The engines' ``shard_min_weight_size=0`` (a JAX option too)
shards every weight the JAX rule can, so the tensor-parallel programs run
on the small model; the ``Generator``, which has no such option, runs at
``GEN_CFG``, wide enough that both packages' defaults shard the block
kernels.  Greedy f32
tokens must be equal three ways; logits may differ by the row-parallel
all-reduce's summation order (ROADMAP C28).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_core_tpu.models.generate import Generator as JaxGenerator
from seldon_core_tpu.models.paged import PagedEngine as JaxPagedEngine
from seldon_core_tpu.models.speculative import SpeculativeGenerator as JaxSpeculativeGenerator
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu.parallel import create_mesh as jax_create_mesh
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.generate import Generator
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM, paged_hbm_accounting
from seldon_core_tpu_torch.models.speculative import SpeculativeGenerator
from seldon_core_tpu_torch.ops.lora import make_lora_params
from seldon_core_tpu_torch.ops.surgery import QuantizedKernel
from seldon_core_tpu_torch.parallel import P, ShardedTensor, create_mesh

CFG = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4, max_len=64)
ENGINE = dict(page_size=8, max_slots=4, steps_per_call=4, prefix_cache=False)
GEN_CFG = dict(CFG, d_model=128)  # every block kernel at least 16,384 elements
MAX_NEW = 8
AXES = [{"model": 2}, {"data": 2}, {"data": 2, "model": 2}]
IDS = ["tp2", "dp2", "dp2xtp2"]


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    for name in ("SELDON_TPU_TP", "SELDON_TPU_DP", "SELDON_TPU_SEQ_SHARD", "SELDON_TPU_CHUNK_IMPL",
                 "SELDON_TPU_PAGED_KERNEL", "SELDON_TPU_KV_DTYPE"):
        monkeypatch.delenv(name, raising=False)


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, CFG["vocab_size"], size=(5 + 3 * i,)).astype(np.int32) for i in range(4)]


def _positions(axes):
    return ["cpu"] * int(np.prod(list(axes.values())))


def _mesh(axes):
    return create_mesh(axes, devices=_positions(axes))


def _jax_mesh(axes):
    return jax_create_mesh(axes, devices=jax.devices()[: len(_positions(axes))])


def _serve(eng, prompts=None, **kw):
    streams = [eng.submit(p, max_new_tokens=MAX_NEW, **kw) for p in (prompts or _prompts())]
    eng.run()
    for s in streams:
        assert s.error is None, s.error
    return np.stack([np.asarray(s.result) for s in streams])


@pytest.fixture(scope="module")
def flax_params():
    lm = FlaxTransformerLM(dtype=jnp.float32, **CFG)
    return jax.device_get(lm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])


@pytest.fixture(scope="module")
def params(flax_params):
    return lm_params_from_flax(flax_params)


@pytest.fixture(scope="module")
def gen_flax_params():
    lm = FlaxTransformerLM(dtype=jnp.float32, **GEN_CFG)
    return jax.device_get(lm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32))["params"])


@pytest.fixture(scope="module")
def one_device(params):
    """The port's one-device engine's greedy tokens (the ring chunk, the
    CPU default, as the mesh engines' default)."""
    return _serve(PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE))


def _port(params, axes, **kw):
    return PagedEngine(params, dtype="float32", mesh=_mesh(axes), shard_min_weight_size=0, **CFG,
                       **{**ENGINE, **kw})


@pytest.mark.parametrize("axes", AXES, ids=IDS)
def test_greedy_ids_equal_jax_s_mesh_engine_and_the_one_device_engine(flax_params, params, one_device, axes):
    eng = _port(params, axes)
    jeng = JaxPagedEngine(flax_params, dtype=jnp.float32, mesh=_jax_mesh(axes), shard_min_weight_size=0, **CFG,
                          **ENGINE)
    mine, theirs = _serve(eng), _serve(jeng)
    np.testing.assert_array_equal(mine, one_device)
    np.testing.assert_array_equal(theirs, one_device)
    stats, jstats = eng.engine_stats(), jeng.engine_stats()
    for key in ("tp_degree", "dp_degree", "pool_shard_bytes"):
        assert stats[key] == jstats[key], key
    assert eng.num_pages == jeng.num_pages and not eng._kernel_active and eng._chunk_impl == "ring"


def test_pool_chunk_and_gather_lane_on_the_mesh(params, one_device, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_CHUNK_IMPL", "pool")
    eng = _port(params, {"data": 2, "model": 2})
    assert eng._chunk_impl == "pool" and not eng._kernel_active
    np.testing.assert_array_equal(_serve(eng), one_device)


def test_seq_shard_off_replicates_the_pages(params, one_device, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_SEQ_SHARD", "0")
    eng = _port(params, {"data": 2, "model": 2})
    assert eng.pages_k.spec == P(None, None, None, "model") and eng.num_pages == 33
    np.testing.assert_array_equal(_serve(eng), one_device)
    # the replicated page dim is held once a distinct device
    assert eng.pages_k.distinct_nbytes() == eng.pages_k.position_nbytes((0, 0)) * 2


def test_pool_pages_round_up_to_a_dp_multiple_and_shard_both_axes(params):
    eng = _port(params, {"data": 2, "model": 2})
    assert eng.num_pages == 34 and eng.pages_k.spec == P(None, "data", None, "model")
    assert eng.pages_k.local((1, 0)).shape == (2, 17, 8, 2, 8)
    # no whole pool on one position: four distinct quarter pools
    assert len({id(t) for t in eng.pages_k.shards.flat}) == 4
    one = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    assert one.num_pages == 33


@pytest.mark.parametrize("axes", AXES, ids=IDS)
def test_accounting_prices_the_shard_a_position_holds(params, axes):
    eng = _port(params, axes)
    acct = paged_hbm_accounting(streams=1, ctx_len=eng.num_pages * eng.page_size, d_model=CFG["d_model"],
                                num_layers=CFG["num_layers"], page_size=eng.page_size, dtype_bytes=4,
                                num_heads=CFG["num_heads"], num_pool_pages=eng.num_pages,
                                tp_degree=eng.tp_degree, dp_degree=eng.dp_degree)
    assert eng.engine_stats()["pool_shard_bytes"] == acct["pool_bytes"]
    assert 2 * eng.pages_k.position_nbytes(tuple(0 for _ in eng.pages_k.mesh.axis_names)) == acct["pool_bytes"]


def test_an_adapter_runs_under_a_tp_mesh(params):
    adapter = make_lora_params(1, num_layers=CFG["num_layers"], d_model=CFG["d_model"], rank=4)
    kw = dict(max_adapters=2, lora_rank=4)
    one = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE, **kw)
    eng = _port(params, {"data": 2, "model": 2}, **kw)
    for e in (one, eng):
        e.load_adapter("a1", adapter)
    # the JAX shardings: column-parallel targets shard B's output dim,
    # row-parallel ones A's input dim
    a, b = eng._lora.buffers["qkv"]
    assert (a.spec, b.spec) == (P(), P(None, None, None, "model"))
    a, b = eng._lora.buffers["mlp_out"]
    assert (a.spec, b.spec) == (P(None, None, "model", None), P())
    prompts = _prompts()[:2]
    with_adapter = _serve(eng, prompts, adapter="a1")
    np.testing.assert_array_equal(with_adapter, _serve(one, prompts, adapter="a1"))
    assert not np.array_equal(with_adapter, _serve(one, prompts))


def test_the_speculative_engine_on_a_mesh(flax_params, params, one_device):
    spec = {"draft": "ngram", "draft_k": 3}
    eng = _port(params, {"data": 2, "model": 2}, speculative=spec)
    jeng = JaxPagedEngine(flax_params, dtype=jnp.float32, mesh=_jax_mesh({"data": 2, "model": 2}),
                          shard_min_weight_size=0, speculative=spec, **CFG, **ENGINE)
    np.testing.assert_array_equal(_serve(eng), one_device)
    np.testing.assert_array_equal(_serve(jeng), one_device)
    assert eng.engine_stats()["spec_drafted"] > 0


@pytest.mark.parametrize("axes", [{"data": 2}, {"data": 2, "model": 2}], ids=["dp2", "dp2xtp2"])
def test_speculative_generator_and_generator_on_a_mesh(flax_params, params, gen_flax_params, axes):
    prompt = _prompts()[2]
    spec = SpeculativeGenerator(params, dtype="float32", mesh=_mesh(axes), page_size=8, draft_k=3,
                                shard_min_weight_size=0, **CFG)
    jspec = JaxSpeculativeGenerator(flax_params, dtype=jnp.float32, mesh=_jax_mesh(axes), page_size=8, draft_k=3,
                                    shard_min_weight_size=0, **CFG)
    plain = SpeculativeGenerator(params, dtype="float32", device="cpu", page_size=8, draft_k=3, **CFG)
    got = spec.generate(prompt, max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(got, np.asarray(jspec.generate(prompt, max_new_tokens=MAX_NEW)))
    np.testing.assert_array_equal(got, plain.generate(prompt, max_new_tokens=MAX_NEW))
    # the generator's pool rounds up to a dp multiple too
    assert spec.target.pk.shape[1] == 10
    rows = np.stack([prompt[:5], prompt[3:8]])
    gen_params = lm_params_from_flax(gen_flax_params)
    gen = Generator(gen_params, dtype="float32", mesh=_mesh(axes), **GEN_CFG)
    jgen = JaxGenerator(gen_flax_params, dtype=jnp.float32, mesh=_jax_mesh(axes), **GEN_CFG)
    if "model" in axes:
        assert gen.module.specs["blocks.0.mlp_out.weight"] != P()  # the block kernels shard
    want = Generator(gen_params, dtype="float32", device="cpu", **GEN_CFG).generate(rows, max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(gen.generate(rows, max_new_tokens=MAX_NEW), want)
    np.testing.assert_array_equal(np.asarray(jgen.generate(rows, max_new_tokens=MAX_NEW)), want)
    assert (gen.tp_degree, gen.dp_degree) == (axes.get("model", 1), 2)


def test_int8w_runs_with_paired_specs(params):
    one = PagedEngine(params, dtype="float32", device="cpu", quantize="int8", **CFG, **ENGINE)
    eng = _port(params, {"data": 2, "model": 2}, quantize="int8")
    spec = eng.module.specs["blocks.0.mlp_in.weight"]
    assert isinstance(spec, QuantizedKernel) and spec.q == P("model", None) and spec.scale == P("model")
    assert eng.quantize_manifest == one.quantize_manifest
    np.testing.assert_array_equal(_serve(eng), _serve(one))
    assert eng.engine_stats()["weight_materializations"] > 0


def test_int8_kv_pool_stays_native_with_jax_s_warn(params, monkeypatch, caplog):
    monkeypatch.setenv("SELDON_TPU_KV_DTYPE", "int8")
    with caplog.at_level(logging.WARNING, logger="seldon_core_tpu_torch.models.paged"):
        eng = _port(params, {"model": 2})
    assert not eng._kv_int8 and eng.pages_k.dtype != np.int8
    assert "int8 KV pool is single-device pool-chunk only" in caplog.text


def test_indivisible_slots_replicate_the_lanes_with_the_warn(params, one_device, caplog):
    with caplog.at_level(logging.WARNING, logger="seldon_core_tpu_torch.models.paged"):
        eng = _port(params, {"data": 2}, max_slots=3)
    assert "decode lanes NOT sharded" in caplog.text and not eng._lane_sharded
    np.testing.assert_array_equal(_serve(eng), one_device)


@pytest.mark.parametrize("axes", [{"model": 2}, {"data": 2, "model": 2}], ids=["tp2", "dp2xtp2"])
def test_w8a8_runs_sharded_with_exact_integer_sums(flax_params, params, axes):
    """Every projection int8 x int8 on the mesh: a row-parallel layer
    all-reduces its int32 partial products before the rescale, so the
    greedy ids equal the one-device w8a8 engine's and the JAX mesh
    engine's."""
    one = PagedEngine(params, dtype="float32", device="cpu", precision="w8a8", **CFG, **ENGINE)
    eng = _port(params, axes, precision="w8a8")
    jeng = JaxPagedEngine(flax_params, dtype=jnp.float32, mesh=_jax_mesh(axes), shard_min_weight_size=0,
                          precision="w8a8", **CFG, **ENGINE)
    wq, sw = eng.module.w8a8["blocks.0.mlp_out.weight"]
    assert wq.spec == P("model", None) and sw.spec == P() and eng.weight_bytes() < one.weight_bytes() * 2
    want = _serve(one)
    np.testing.assert_array_equal(_serve(eng), want)
    np.testing.assert_array_equal(_serve(jeng), want)


def test_a_handoff_leaves_the_mesh_and_decodes_on_one_device(params, one_device):
    """A prefill on the mesh engine exports its pages (gathered from the
    positions that hold them) and a one-device engine decodes them."""
    src = _port(params, {"data": 2, "model": 2})
    dst = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    prompt = _prompts()[3]
    payload = src.prefill_export(prompt)
    stream = dst.submit_prefilled(payload, max_new_tokens=MAX_NEW)
    dst.run()
    np.testing.assert_array_equal(np.asarray(stream.result), one_device[3])
    # and back: the one-device engine's export lands on the mesh's shards
    back = _port(params, {"data": 2, "model": 2})
    stream = back.submit_prefilled(dst.prefill_export(prompt), max_new_tokens=MAX_NEW)
    back.run()
    np.testing.assert_array_equal(np.asarray(stream.result), one_device[3])
    assert isinstance(back.pages_k, ShardedTensor)


def test_streaminglm_mesh_axes_gauges_and_records(params, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_FLIGHT_RECORDER", "64")
    comp = StreamingLM(device="cpu", dtype="float32", mesh_axes={"data": 2, "model": 2}, max_slots=2,
                       steps_per_call=2, page_size=8, max_new_tokens=4, **CFG)
    comp.load()
    try:
        out = comp.predict(np.array([[1, 2, 3, 4]]), [])
        assert out.shape == (1, 4)
        gauges = {m["key"]: m["value"] for m in comp.metrics()}
        assert (gauges["paged_tp_degree"], gauges["paged_dp_degree"]) == (2, 2)
        records = comp.engine.recorder.snapshot()
        assert records and all((r["tp_degree"], r["dp_degree"]) == (2, 2) for r in records)
    finally:
        comp.shutdown()

"""The port's single-stream speculative decoding against the JAX package's.

``ngram_draft`` is compared with JAX's case for case and on seeded
contexts.  ``SpeculativeGenerator`` runs the same flax ``TransformerLM``
init in float32 in both packages (converted by ``models/convert.py``),
with an ngram draft, a perfect draft model (the target's own weights)
and a wrong one (another init of another size): tokens and ``stats``
must equal JAX's exactly, and the tokens plain greedy decoding's (the
port's ``PagedEngine``).  Around them: eos truncation and padding, the
headroom 400, a ``chunk_token_budget`` prefill, int8 kernels at rest,
and the paged-decode kernel called once per draft layer per one-token
forward under ``SELDON_TPU_PAGED_KERNEL=force``.  ``SpeculativeLM``
serves a msgpack checkpoint as the JAX component does, exports its two
gauges, refuses meshes, and builds as a ``SPECULATIVE_LM`` graph node
behind the port's gateway.
"""

import asyncio
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as flax_serialization

from seldon_core_tpu.models import speculative as jax_spec
from seldon_core_tpu.models.generate import load_lm_params as jax_load_lm_params
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu_torch.engine import PredictorService, UnitSpec, server, units
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine
from seldon_core_tpu_torch.models.speculative import SpeculativeGenerator, SpeculativeLM, ngram_draft
from seldon_core_tpu_torch.ops import kernels
from seldon_core_tpu_torch.runtime import MicroserviceError

CFG = dict(vocab_size=64, d_model=64, num_layers=2, num_heads=2, max_len=128)
WRONG_CFG = dict(d_model=32, num_layers=1, num_heads=2)  # the wrong draft: another init, another size
PAGE = 8
DRAFT_K = 4
MAX_NEW = 12


def _prompts():
    rng = np.random.default_rng(31)
    rep = np.array([5, 9, 5, 9, 5, 9, 5], np.int32)
    return [rep, rng.integers(0, CFG["vocab_size"], 3).astype(np.int32),
            np.tile(rng.integers(0, CFG["vocab_size"], 6), 4).astype(np.int32)[:21],
            rng.integers(0, CFG["vocab_size"], 30).astype(np.int32)]


@pytest.fixture(scope="module")
def flax_params():
    return FlaxTransformerLM(dtype=jnp.float32, **CFG).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def flax_wrong():
    cfg = {**CFG, **WRONG_CFG}
    return FlaxTransformerLM(dtype=jnp.float32, **cfg).init(jax.random.key(7), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(flax_params):
    return lm_params_from_flax(flax_params)


@pytest.fixture(scope="module")
def wrong(flax_wrong):
    return lm_params_from_flax(flax_wrong)


# case -> generator options (the draft's params picked by name)
CASES = {
    "ngram": dict(draft="ngram"),
    "self-draft": dict(draft="model", draft_params="target"),
    "wrong-draft": dict(draft="model", draft_params="wrong", draft_config=WRONG_CFG),
    "budget": dict(draft="ngram", chunk_token_budget=PAGE),
    "int8": dict(draft="model", draft_params="wrong", draft_config=WRONG_CFG, quantize="int8"),
}


def _kw(case, target, other):
    kw = dict(CASES[case])
    if "draft_params" in kw:
        kw["draft_params"] = {"target": target, "wrong": other}[kw["draft_params"]]
    return kw


def _serve(gen, prompts, **kw):
    return [gen.generate(p, max_new_tokens=MAX_NEW, **kw).tolist() for p in prompts]


@pytest.fixture(scope="module")
def jax_runs(flax_params, flax_wrong):
    out = {}
    for case in CASES:
        gen = jax_spec.SpeculativeGenerator(flax_params, dtype=jnp.float32, page_size=PAGE, draft_k=DRAFT_K,
                                            **_kw(case, flax_params, flax_wrong), **CFG)
        out[case] = (_serve(gen, _prompts()), dict(gen.stats))
    return out


def _port_gen(case, params, wrong, **extra):
    return SpeculativeGenerator(params, dtype="float32", device="cpu", page_size=PAGE, draft_k=DRAFT_K,
                                **_kw(case, params, wrong), **CFG, **extra)


@pytest.fixture(scope="module")
def port_runs(params, wrong):
    out = {}
    for case in CASES:
        gen = _port_gen(case, params, wrong)
        out[case] = (_serve(gen, _prompts()), dict(gen.stats))
    return out


@pytest.fixture(scope="module")
def greedy(params):
    eng = PagedEngine(params, dtype="float32", device="cpu", page_size=PAGE, max_slots=4, prefix_cache=False, **CFG)
    streams = [eng.submit(p, max_new_tokens=MAX_NEW) for p in _prompts()]
    eng.run()
    return [s.result.tolist() for s in streams]


# ---------------------------------------------------------------- ngram_draft


@pytest.mark.parametrize("ctx,k,want", [
    ([7, 1, 2, 3, 9, 1, 2], 3, [3, 9, 1]),  # suffix (1, 2) matched at index 1
    ([1, 2, 5, 1, 2, 8, 1, 2], 1, [8]),     # the latest match wins
    ([4, 9, 4], 2, [9, 4]),                 # unigram fallback
    ([1, 2, 3], 2, []),                     # no match
])
def test_ngram_draft_cases_of_the_jax_suite(ctx, k, want):
    ctx = np.asarray(ctx, np.int32)
    np.testing.assert_array_equal(ngram_draft(ctx, k), want)
    np.testing.assert_array_equal(ngram_draft(ctx, k), jax_spec.ngram_draft(ctx, k))


def test_ngram_draft_equals_jaxs_on_seeded_contexts():
    rng = np.random.default_rng(5)
    found = 0
    for _ in range(300):
        ctx = rng.integers(0, 6, int(rng.integers(1, 24))).astype(np.int32)
        k, n = int(rng.integers(1, 6)), int(rng.integers(1, 4))
        got, want = ngram_draft(ctx, k, ngram=n), jax_spec.ngram_draft(ctx, k, ngram=n)
        assert got.dtype == want.dtype and got.tolist() == want.tolist(), (ctx, k, n)
        found += len(got) > 0
    assert found > 100  # the contexts reach the matching branch


# ---------------------------------------------------------------- SpeculativeGenerator


@pytest.mark.parametrize("case", list(CASES))
def test_generator_equals_jaxs_tokens_and_stats(jax_runs, port_runs, case):
    (want_toks, want_stats), (got_toks, got_stats) = jax_runs[case], port_runs[case]
    assert got_toks == want_toks
    assert got_stats == want_stats


@pytest.mark.parametrize("case", [c for c in CASES if c != "int8"])
def test_generator_tokens_equal_plain_greedy(port_runs, greedy, case):
    assert port_runs[case][0] == greedy


def test_the_drafts_reach_their_paths(port_runs):
    stats = {case: s for case, (_t, s) in port_runs.items()}
    # a perfect draft is accepted whole; a wrong one mostly is not
    assert stats["self-draft"]["accepted"] == stats["self-draft"]["drafted"] > 0
    assert stats["wrong-draft"]["accepted"] < stats["wrong-draft"]["drafted"]
    assert stats["self-draft"]["rounds"] < stats["ngram"]["rounds"]
    assert stats["ngram"]["accepted"] > 0


def test_eos_truncates_and_pads_as_jax(flax_params, params, greedy):
    prompt = _prompts()[0]
    eos = greedy[0][2]  # the third greedy token: inside an accepted run
    want = jax_spec.SpeculativeGenerator(flax_params, dtype=jnp.float32, page_size=PAGE, draft_k=DRAFT_K,
                                         **CFG).generate(prompt, MAX_NEW, eos_id=eos)
    got = SpeculativeGenerator(params, dtype="float32", device="cpu", page_size=PAGE, draft_k=DRAFT_K,
                               **CFG).generate(prompt, MAX_NEW, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    cut = greedy[0].index(eos) + 1
    assert got.tolist() == greedy[0][:cut] + [eos] * (MAX_NEW - cut)


def test_the_headroom_is_a_400_as_in_jax(params):
    gen = SpeculativeGenerator(params, dtype="float32", device="cpu", page_size=PAGE, draft_k=DRAFT_K, **CFG)
    plen = CFG["max_len"] - MAX_NEW - DRAFT_K  # one position short of the headroom
    with pytest.raises(MicroserviceError) as err:
        gen.generate(np.ones((plen,), np.int32), MAX_NEW)
    assert err.value.status_code == 400 and err.value.reason == "SEQUENCE_TOO_LONG"
    assert gen.generate(np.ones((plen - 1,), np.int32), MAX_NEW).shape == (MAX_NEW,)
    with pytest.raises(MicroserviceError, match="non-empty"):
        gen.generate(np.zeros((0,), np.int32), MAX_NEW)


def test_a_budget_prefills_in_page_chunks(port_runs, params):
    gen = _port_gen("budget", params, None)
    assert gen.chunk_token_budget == PAGE
    calls = []
    real = gen._forward_chunk
    gen._forward_chunk = lambda *a: calls.append(a[1].shape[1]) or real(*a)
    prompt = _prompts()[3]
    assert gen.generate(prompt, MAX_NEW).tolist() == port_runs["budget"][0][3]
    assert calls == [PAGE] * -(-len(prompt) // PAGE)


def test_int8_kernels_rest_int8(params, wrong):
    gen = _port_gen("int8", params, wrong)
    assert gen.quantize_manifest and gen.target._qkernels and gen.draft_state._qkernels
    key = next(iter(gen.target._qkernels))
    assert gen.target.module.get_parameter(key).numel() == 0  # no float copy at rest


def test_one_token_forwards_call_the_kernel_once_a_draft_layer(params, wrong, port_runs, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", "force")
    calls = []
    real = kernels.paged_attention_decode
    monkeypatch.setattr(kernels, "paged_attention_decode", lambda q, *a, **k: calls.append(q.shape) or real(q, *a, **k))
    gen = _port_gen("wrong-draft", params, wrong)
    assert gen._use_kernel
    assert _serve(gen, _prompts()) == port_runs["wrong-draft"][0]  # f32: the kernel lane's tokens are the gather lane's
    assert gen.single_token_forwards > 0
    assert len(calls) == WRONG_CFG["num_layers"] * gen.single_token_forwards
    assert {s[0] for s in calls} == {1}  # one lane, never the target's verify


def test_the_gather_lane_by_default_on_the_cpu(params, wrong, monkeypatch):
    monkeypatch.delenv("SELDON_TPU_PAGED_KERNEL", raising=False)
    calls = []
    monkeypatch.setattr(kernels, "paged_attention_decode", lambda *a, **k: calls.append(1))
    gen = _port_gen("self-draft", params, wrong)
    gen.generate(_prompts()[0], MAX_NEW)
    assert not gen._use_kernel and gen.single_token_forwards > 0 and calls == []


def test_generator_refuses_what_jax_refuses(params, flax_params):
    with pytest.raises(ValueError, match="draft must be"):
        SpeculativeGenerator(params, device="cpu", draft="oracle", page_size=PAGE, **CFG)
    with pytest.raises(ValueError, match="draft_params"):
        SpeculativeGenerator(params, device="cpu", draft="model", page_size=PAGE, **CFG)
    # tp once raised here (A12 landed): over a {"model": 2} mesh of CPU
    # positions the generator decodes the JAX generator's tokens on its
    # two-device mesh
    from seldon_core_tpu.parallel import create_mesh as jax_create_mesh
    from seldon_core_tpu_torch.parallel import create_mesh

    prompt = _prompts()[0]
    gen = SpeculativeGenerator(params, dtype="float32", mesh=create_mesh({"model": 2}, devices=["cpu"] * 2),
                               page_size=PAGE, draft_k=DRAFT_K, shard_min_weight_size=0, **CFG)
    jgen = jax_spec.SpeculativeGenerator(flax_params, dtype=jnp.float32, page_size=PAGE, draft_k=DRAFT_K,
                                         mesh=jax_create_mesh({"model": 2}, devices=jax.devices()[:2]),
                                         shard_min_weight_size=0, **CFG)
    assert gen.tp_degree == 2
    np.testing.assert_array_equal(gen.generate(prompt, max_new_tokens=MAX_NEW),
                                  np.asarray(jgen.generate(prompt, max_new_tokens=MAX_NEW)))


# ---------------------------------------------------------------- SpeculativeLM


@pytest.fixture(scope="module")
def lm_files(tmp_path_factory, flax_params, flax_wrong):
    d = tmp_path_factory.mktemp("spec")
    for name, tree in (("lm", flax_params), ("draft", flax_wrong)):
        (d / f"{name}.msgpack").write_bytes(flax_serialization.to_bytes(jax.tree_util.tree_map(np.asarray, tree)))
    return f"file://{d / 'lm.msgpack'}", f"file://{d / 'draft.msgpack'}"


def _lm_kw(case, lm_uri, draft_uri):
    kw = dict(model_uri=lm_uri, page_size=PAGE, draft_k=DRAFT_K, max_new_tokens=MAX_NEW, **CFG)
    if case == "model":
        kw.update(draft="model", draft_uri=draft_uri, draft_config=WRONG_CFG)
    return kw


@pytest.mark.parametrize("case", ["ngram", "model"])
def test_speculative_lm_serves_the_jax_components_rows(lm_files, case):
    kw = _lm_kw(case, *lm_files)
    jax_lm = jax_spec.SpeculativeLM(**kw)
    # the JAX component decodes in bfloat16; the comparison holds in
    # float32 (C3), so its generator is built at f32 from what its load
    # reads: the checkpoints, the draft's config merged over the target's
    cfg = dict(CFG)
    draft = None
    if case == "model":
        draft = jax_load_lm_params(kw["draft_uri"], {**CFG, **WRONG_CFG}, 1)
    jax_lm.generator = jax_spec.SpeculativeGenerator(
        jax_load_lm_params(kw["model_uri"], cfg, 0), dtype=jnp.float32, page_size=PAGE, draft=jax_lm.draft,
        draft_k=DRAFT_K, draft_params=draft, draft_config=jax_lm.draft_config, **CFG)
    lm = SpeculativeLM(device="cpu", dtype="float32", **kw)
    X = np.stack([p[:7] for p in _prompts() if len(p) >= 7])
    want = jax_lm.predict(X, [])
    got = lm.predict(X, [])
    np.testing.assert_array_equal(got, want)
    assert lm.generator.stats == jax_lm.generator.stats
    got_m = {m["key"]: m["value"] for m in lm.metrics()}
    want_m = {m["key"]: m["value"] for m in jax_lm.metrics()}
    assert got_m == pytest.approx(want_m) and set(got_m) == {"speculative_acceptance_rate", "speculative_rounds"}
    assert all(m["type"] == "GAUGE" for m in lm.metrics())


def test_speculative_lm_seeds_its_draft_with_seed_plus_one(monkeypatch):
    seen = []
    from seldon_core_tpu_torch.models import speculative

    real = speculative.load_lm_params
    monkeypatch.setattr(speculative, "load_lm_params", lambda uri, cfg, seed, dev: seen.append((seed, cfg["d_model"]))
                        or real(uri, cfg, seed, dev))
    lm = SpeculativeLM(device="cpu", dtype="float32", seed=3, draft="model", draft_config={"d_model": 32},
                       page_size=PAGE, **CFG)
    lm.load()
    lm.load()  # idempotent
    assert seen == [(3, CFG["d_model"]), (4, 32)]


@pytest.mark.parametrize("kw", [dict(tp=2), dict(dp=2), dict(mesh_axes={"model": 2})], ids=["tp", "dp", "mesh"])
def test_speculative_lm_serves_on_meshes_as_on_one_device(kw, lm_files, monkeypatch):
    """The mesh options once raised naming A12; they landed.  ``tp`` /
    ``dp`` count distinct CUDA devices and degrade to one device on a
    host without them; ``mesh_axes`` on a CPU component lays the
    generator over that many CPU positions.  Every case serves the rows
    the one-device component serves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lm_uri, _ = lm_files
    common = dict(model_uri=lm_uri, page_size=PAGE, draft_k=DRAFT_K, max_new_tokens=MAX_NEW, dtype="float32",
                  device="cpu", **CFG)
    lm = SpeculativeLM(**common, **kw)
    ref = SpeculativeLM(**common)
    X = np.stack([p[:7] for p in _prompts() if len(p) >= 7])
    np.testing.assert_array_equal(lm.predict(X, []), ref.predict(X, []))
    want = (2, 1) if "mesh_axes" in kw else (1, 1)
    assert (lm.generator.tp_degree, lm.generator.dp_degree) == want


def test_speculative_lm_metrics_before_load():
    lm = SpeculativeLM(device="cpu", **CFG)
    assert {m["key"]: m["value"] for m in lm.metrics()} == {"speculative_acceptance_rate": 0.0,
                                                            "speculative_rounds": 0.0}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_speculative_lm_node_serves_behind_the_gateway(lm_files, flax_params):
    import aiohttp

    assert units._lookup_builtin("SPECULATIVE_LM") is SpeculativeLM
    lm_uri, _ = lm_files
    values = dict(model_uri=lm_uri, page_size=PAGE, draft_k=DRAFT_K, max_new_tokens=MAX_NEW, device="cpu",
                  dtype="float32", **CFG)
    types = {str: "STRING", int: "INT"}
    parameters = [{"name": k, "value": str(v), "type": types[type(v)]} for k, v in values.items()]
    spec = UnitSpec.from_dict({"name": "spec", "type": "MODEL", "implementation": "SPECULATIVE_LM",
                               "parameters": parameters, "children": []})
    svc = PredictorService(spec, name="main")
    prompt = _prompts()[0]
    want = jax_spec.SpeculativeGenerator(flax_params, dtype=jnp.float32, page_size=PAGE, draft_k=DRAFT_K,
                                         **CFG).generate(prompt, MAX_NEW)

    async def go():
        gw = server.Gateway([(svc, 1.0)])
        http_port = _free_port()
        runner, handle = await server.serve_gateway(gw, host="127.0.0.1", http_port=http_port,
                                                    grpc_port=_free_port())
        try:
            async with aiohttp.ClientSession() as session:
                async with session.post(f"http://127.0.0.1:{http_port}/api/v0.1/predictions",
                                        json={"data": {"ndarray": [prompt.tolist()]}}) as resp:
                    assert resp.status == 200, await resp.text()
                    return await resp.json()
        finally:
            await handle.stop(None)
            await runner.cleanup()

    body = asyncio.run(go())
    assert np.asarray(body["data"]["ndarray"]).astype(np.int64).tolist() == [want.tolist()]
    keys = {m["key"] for m in body["meta"]["metrics"]}
    assert {"speculative_acceptance_rate", "speculative_rounds"} <= keys

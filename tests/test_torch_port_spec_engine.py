"""The port's speculative ``PagedEngine`` against the JAX engine's.

Both engines run the same flax ``TransformerLM`` init in float32 with
``speculative=`` on one submission order per case: ngram, oracle (the
plain tokens as hints: every draft accepted), a perfect draft model (the
target's own weights) and a wrong one (another init, another size, a
sliding window), concurrent mixed-length streams, eos inside an accepted
run, two adapters, an int8 pool, ``precision="w8a8"``, a prefix hit with
the allocator audit on, a ``chunk_token_budget``, and a shrunk pool that
stalls and evicts (the JAX suite's ``tests/test_paged.py:140-260``,
``test_prefix_cache.py:357-370``, ``test_w8a8.py:307`` and
``test_lora.py:540``).  In every case the greedy tokens equal JAX's and
the plain port engine's, exactly; ``chunks``, ``spec_drafted`` and
``spec_accepted`` equal JAX's; each stream's pool K/V below its length
after the first verify round lies within 1e-5 of the largest value of
JAX's; and the verify rounds make no paged-decode call.  Two cases carry
the rule the repo records for their lane, in JAX as in the port: an
int8 pool requantises a page with each verify segment's rejected tokens
in it, so its tokens equal JAX's speculative engine but only agree with
plain decoding (C9); and w8a8's dynamic per-token activation grid may
move one prompt token's integers by a step when a float differs in its
last bit, in the plain prefill as well (C12).  Around them:
the 400s, the options JAX refuses, and ``StreamingLM(speculative=...)``
serving, streaming and exporting its two gauges.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization as flax_serialization

from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models import registry as jax_registry
from seldon_core_tpu.models.generate import load_lm_params as jax_load_lm_params
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu_torch.models import registry
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM
from seldon_core_tpu_torch.ops import kernels, lora
from seldon_core_tpu_torch.runtime import MicroserviceError

CFG = dict(vocab_size=64, d_model=64, num_layers=2, num_heads=2, max_len=128)
WRONG_CFG = dict(d_model=32, num_layers=1, num_heads=2, max_len=128)
ENGINE = dict(page_size=8, max_slots=4, steps_per_call=4)
RANK = 2
MAX_NEW = 10
REL = 1e-5
# C12: one token's K/V a stream may sit a step of w8a8's activation grid
# away (~0.8% of the largest value in the case here)
W8A8_STEP_REL = 1e-2


@contextlib.contextmanager
def _env(**kv):
    before = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _prompts(case):
    rng = np.random.default_rng(41)
    if case == "prefix":
        # a two-page shared prefix: every prompt after the first maps it
        shared = np.tile(rng.integers(0, CFG["vocab_size"], 4), 4).astype(np.int32)
        return [np.concatenate([shared, rng.integers(0, CFG["vocab_size"], n).astype(np.int32)])
                for n in (3, 5, 2, 6)]
    if case == "tight":
        return [rng.integers(0, CFG["vocab_size"], n).astype(np.int32) for n in (13, 15, 14, 14)]
    return [np.array([5, 9, 5, 9, 5], np.int32), np.array([1, 2], np.int32),
            np.arange(11, dtype=np.int32) % CFG["vocab_size"],
            np.tile(rng.integers(0, CFG["vocab_size"], 5), 3).astype(np.int32)]


def _adapters():
    return {f"t{i}": lora.make_lora_params(300 + i, num_layers=CFG["num_layers"], d_model=CFG["d_model"], rank=RANK)
            for i in range(2)}


def _registry(mod):
    reg = mod.WeightRegistry(budget_bytes=0)
    for name, ad in _adapters().items():
        reg.register(name, (lambda a=ad: a), bytes_hint=lora.adapter_bytes(ad))
    return reg


NGRAM = {"draft": "ngram", "draft_k": 3}
# case -> (speculative options, engine options, environment); a draft
# model's params are named and supplied per package
CASES = {
    "ngram": (NGRAM, {}, {}),
    "oracle": ({"draft": "oracle", "draft_k": 4}, {}, {}),
    "self-draft": ({"draft": "model", "draft_k": 4, "draft_params": "target", "draft_config": CFG}, {}, {}),
    "wrong-draft": ({"draft": "model", "draft_k": 3, "draft_params": "wrong", "draft_config": WRONG_CFG,
                     "draft_window": 12}, {}, {}),
    "eos": (NGRAM, {}, {}),
    "adapters": (NGRAM, {"max_adapters": 2, "lora_rank": RANK}, {}),
    "int8-pool": (NGRAM, {}, {"SELDON_TPU_KV_DTYPE": "int8", "SELDON_TPU_CHUNK_IMPL": "pool"}),
    "w8a8": (NGRAM, {"precision": "w8a8"}, {}),
    "prefix": (NGRAM, {"prefix_cache": True}, {"SELDON_TPU_PAGED_DEBUG": "1"}),
    "budget": (NGRAM, {"chunk_token_budget": 16}, {}),
    # 8 usable pages: four 2-page prompts fill the pool and each stalls
    # for the page its verify segment reaches
    "tight": (NGRAM, {"num_pages": 9}, {}),
}
ADAPTER_MIX = ["t1", None, "t0", "t1"]


def _options(case, mod, target, wrong):
    spec, kw, env = CASES[case]
    spec = dict(spec)
    if "draft_params" in spec:
        spec["draft_params"] = {"target": target, "wrong": wrong}[spec["draft_params"]]
    kw = {"prefix_cache": False, **kw}
    if "max_adapters" in kw:
        kw["weight_registry"] = _registry(mod)
    return spec, kw, {"SELDON_TPU_PAGED_KERNEL": None, "SELDON_TPU_CHUNK_IMPL": None, "SELDON_TPU_KV_DTYPE": None,
                      "SELDON_TPU_PAGED_DEBUG": None, **env}


def _pool(pages, scales, n_layers):
    """A pool as (layers, pages, page_size, d_model) float32 numpy, int8
    pages dequantised by their per-page scales."""
    a = np.asarray(pages, np.float32)
    if scales is not None:
        a = a * np.asarray(scales, np.float32).reshape(*np.shape(scales), *(1,) * (a.ndim - 2))
    return a.reshape(n_layers, a.shape[1], a.shape[2], -1)


def _contents(eng, streams, pk, pv):
    ps = ENGINE["page_size"]
    out = []
    for s in streams:
        n = int(eng._lengths[s.slot])
        pages = np.asarray(eng._block_tables[s.slot, : -(-n // ps)])
        out.append(tuple(p[:, pages].reshape(CFG["num_layers"], -1, p.shape[-1])[:, :n] for p in (pk, pv)))
    return out


def _drive(eng, case, pools, hints=None, eos=None):
    """Greedy tokens, the pool contents of the live streams after the
    first verify wave, and the engine's counters."""
    prompts = _prompts(case)
    if case == "prefix":
        eng.submit(prompts[0], max_new_tokens=MAX_NEW)  # publishes the shared pages
        eng.run()
    mix = ADAPTER_MIX if case == "adapters" else [None] * len(prompts)
    extra = {} if eos is None else {"eos_id": eos}
    streams = [eng.submit(p, max_new_tokens=MAX_NEW, adapter=a, draft_hint=None if hints is None else hints[i],
                          **extra) for i, (p, a) in enumerate(zip(prompts, mix))]
    eng.step()  # admission, prefill and the first verify round
    live = [s for s in streams if s.slot is not None and eng._slots[s.slot] is s]
    contents = _contents(eng, live, *pools(eng))
    eng.run()
    return {"tokens": [s.result.tolist() for s in streams], "contents": contents, "stats": eng.engine_stats()}


def _jax_pools(eng):
    return [_pool(p, s, CFG["num_layers"]) for p, s in ((eng.pages_k, eng.scales_k), (eng.pages_v, eng.scales_v))]


def _port_pools(eng):
    return [_pool(p.numpy(), None if s is None else s.numpy(), CFG["num_layers"])
            for p, s in ((eng.pages_k, eng.scales_k), (eng.pages_v, eng.scales_v))]


@pytest.fixture(scope="module")
def flax_params():
    return FlaxTransformerLM(dtype=jnp.float32, **CFG).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def flax_wrong():
    return FlaxTransformerLM(dtype=jnp.float32, **{**CFG, **WRONG_CFG}).init(
        jax.random.key(9), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(flax_params):
    return lm_params_from_flax(flax_params)


@pytest.fixture(scope="module")
def wrong(flax_wrong):
    return lm_params_from_flax(flax_wrong)


def _port(case, params, wrong, speculative=True, **env):
    spec, kw, base_env = _options(case, registry, params, wrong)
    with _env(**{**base_env, **env}):
        return PagedEngine(params, dtype="float32", device="cpu", speculative=spec if speculative else None,
                           **CFG, **{**ENGINE, **kw})


@pytest.fixture(scope="module")
def plain_runs(params, wrong):
    """The plain port engine's greedy tokens per case (the same engine
    options, no speculation): the oracle's hints, the eos case's eos."""
    out = {}
    for case in CASES:
        eng = _port(case, params, wrong, speculative=False)
        with _env(**_options(case, registry, params, wrong)[2]):
            out[case] = _drive(eng, case, _port_pools)["tokens"]
    return out


def _case_inputs(case, plain_runs):
    hints = plain_runs["oracle"] if case == "oracle" else None
    # the fourth greedy token of the third stream: past its prompt's
    # repeats, so ngram drafts run through it
    eos = plain_runs["eos"][2][3] if case == "eos" else None
    return hints, eos


@pytest.fixture(scope="module")
def jax_runs(flax_params, flax_wrong, plain_runs):
    out = {}
    for case in CASES:
        spec, kw, env = _options(case, jax_registry, flax_params, flax_wrong)
        with _env(**env):
            eng = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, speculative=spec, **CFG, **{**ENGINE, **kw})
            out[case] = _drive(eng, case, _jax_pools, *_case_inputs(case, plain_runs))
        eng.close()
    return out


@pytest.fixture(scope="module")
def port_runs(params, wrong, plain_runs):
    out = {}
    for case in CASES:
        eng = _port(case, params, wrong)
        with _env(**_options(case, registry, params, wrong)[2]):
            out[case] = _drive(eng, case, _port_pools, *_case_inputs(case, plain_runs))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_speculative_engine_equals_the_jax_engine(jax_runs, port_runs, case):
    got, want = port_runs[case], jax_runs[case]
    assert got["tokens"] == want["tokens"]
    for key in ("chunks", "spec_drafted", "spec_accepted", "tokens", "stalls", "evictions", "prefix_hits"):
        assert got["stats"][key] == want["stats"][key], key
    assert len(got["contents"]) == len(want["contents"]) > 0
    for (gk, gv), (wk, wv) in zip(got["contents"], want["contents"]):
        assert gk.shape == wk.shape
        for g, w in ((gk, wk), (gv, wv)):
            scale = np.abs(w).max()
            off = np.abs(g - w) > REL * scale + REL * np.abs(w)
            if case == "w8a8":
                # C12: at most one token position outside, within a grid step
                assert len(np.unique(np.nonzero(off)[1])) <= 1
                np.testing.assert_allclose(g, w, rtol=0, atol=W8A8_STEP_REL * scale)
            else:
                assert not off.any(), np.abs(g - w).max()


def _cut(rows, eos):
    """Rows as a stream delivers them under ``eos``: cut after the first
    eos and padded with it."""
    out = []
    for r in rows:
        r = r[: r.index(eos) + 1] if eos in r else r
        out.append(r + [eos] * (MAX_NEW - len(r)))
    return out


@pytest.mark.parametrize("case", [c for c in CASES if c != "int8-pool"])
def test_speculative_tokens_equal_the_plain_engines(port_runs, plain_runs, case):
    want = plain_runs[case]
    if case == "eos":
        want = _cut(want, _case_inputs(case, plain_runs)[1])
    assert port_runs[case]["tokens"] == want


def test_an_int8_pool_agrees_with_plain_decoding_as_c9_holds_it(port_runs, plain_runs):
    got, want = np.asarray(port_runs["int8-pool"]["tokens"]), np.asarray(plain_runs["int8-pool"])
    assert (got[:, 0] == want[:, 0]).all() and np.mean(got == want) >= 0.75


def test_the_cases_reach_their_paths(port_runs, plain_runs):
    s = {case: r["stats"] for case, r in port_runs.items()}
    assert s["oracle"]["spec_accepted"] == s["oracle"]["spec_drafted"] > 0
    assert s["self-draft"]["spec_accepted"] == s["self-draft"]["spec_drafted"] > 0
    assert s["wrong-draft"]["spec_accepted"] < s["wrong-draft"]["spec_drafted"]
    assert s["ngram"]["spec_accepted"] > 0 and s["ngram"]["chunks"] < sum(len(t) for t in plain_runs["ngram"])
    eos = _case_inputs("eos", plain_runs)[1]
    third = port_runs["eos"]["tokens"][2]
    assert third[:4] == plain_runs["eos"][2][:4] and set(third[4:]) == {eos} and s["eos"]["spec_accepted"] > 0
    assert s["adapters"]["adapters_resident"] == 2 and port_runs["adapters"]["tokens"] != port_runs["ngram"]["tokens"]
    assert s["int8-pool"]["kv_dtype_int8"] == 1
    assert s["prefix"]["prefix_hits"] == 4
    assert s["budget"]["prefill_chunks"] > s["ngram"]["prefill_chunks"]
    assert s["tight"]["stalls"] > 0 and s["tight"]["evictions"] > 0
    for r in s.values():
        # every page back: free, or cached when the prefix cache holds it
        assert r["free_pages"] + r["prefix_pages_cached"] == r["pool_pages_total"] and r["active"] == 0


@pytest.mark.parametrize("case", ["ngram", "self-draft", "adapters", "int8-pool"])
def test_the_verify_rounds_make_no_paged_decode_call(params, wrong, port_runs, plain_runs, monkeypatch, case):
    calls = []
    real = kernels.paged_attention_decode
    monkeypatch.setattr(kernels, "paged_attention_decode", lambda *a, **k: calls.append(1) or real(*a, **k))
    eng = _port(case, params, wrong, SELDON_TPU_PAGED_KERNEL="force")
    assert eng._kernel_active
    got = _drive(eng, case, _port_pools, *_case_inputs(case, plain_runs))
    assert got["tokens"] == port_runs[case]["tokens"]
    assert got["stats"]["chunks"] > 0 and calls == []


def test_the_audit_stays_clean_with_the_cache_under_repeats(params, wrong):
    eng = _port("prefix", params, wrong, SELDON_TPU_PAGED_DEBUG="1")
    assert eng._debug_invariants and eng._prefix_cache_enabled
    streams = [eng.submit(p, max_new_tokens=MAX_NEW) for p in _prompts("prefix") * 2]
    eng.run()  # audited at every wave boundary
    assert all(s.result is not None for s in streams)
    # the verify segments' headroom pages went back with every stream;
    # the first wave's four admissions miss, the second's four hit
    s = eng.engine_stats()
    assert s["free_pages"] + s["prefix_pages_cached"] == eng.num_pages - 1 and s["prefix_hits"] == 4


def test_cancel_frees_the_headroom_pages(params, wrong):
    eng = _port("ngram", params, wrong, SELDON_TPU_PAGED_DEBUG="1")
    st = eng.submit(np.arange(14, dtype=np.int32), max_new_tokens=MAX_NEW)
    eng.step()
    assert len(st.pages) > -(-len(st.prompt) // ENGINE["page_size"])  # grown for the verify segment
    eng.cancel(st)
    eng.run()
    assert st.result is not None and eng.engine_stats()["free_pages"] == eng.num_pages - 1


def test_sampling_is_a_400_as_in_jax(flax_params, params):
    want = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, speculative=NGRAM, **CFG, **ENGINE)
    got = PagedEngine(params, dtype="float32", device="cpu", speculative=NGRAM, **CFG, **ENGINE)
    errors = []
    for eng in (want, got):
        with pytest.raises(Exception) as err:
            eng.submit(np.array([1, 2, 3], np.int32), max_new_tokens=4, temperature=0.9)
        errors.append(err.value)
    want.close()
    assert errors[1].status_code == errors[0].status_code == 400 and errors[1].reason == "BAD_REQUEST"
    assert str(errors[1]) == str(errors[0])


def test_the_headroom_is_in_the_length_check(params):
    eng = PagedEngine(params, dtype="float32", device="cpu", speculative=NGRAM, **CFG, **ENGINE)
    plen = CFG["max_len"] - MAX_NEW - NGRAM["draft_k"]
    with pytest.raises(MicroserviceError) as err:
        eng.submit(np.ones((plen,), np.int32), max_new_tokens=MAX_NEW)
    assert err.value.reason == "SEQUENCE_TOO_LONG"
    assert eng.generate(np.ones((plen - 1,), np.int32), max_new_tokens=MAX_NEW).shape == (MAX_NEW,)


@pytest.mark.parametrize("spec,match", [
    ({"draft": "lookahead"}, "supports draft="),
    ({"draft_k": 0}, "draft_k must be >= 1"),
    ({"draft": "model"}, "needs draft_params"),
    ({"draft": "model", "draft_params": "wrong", "draft_config": {**WRONG_CFG, "vocab_size": 32}}, "vocab_size"),
    ({"draft": "model", "draft_params": "wrong", "draft_config": {**WRONG_CFG, "max_len": 32}}, "cover draft_window"),
])
def test_options_refused_as_jax_refuses_them(flax_params, flax_wrong, params, wrong, spec, match):
    for mod, target, other, build in (
            ("jax", flax_params, flax_wrong, lambda s: jax_paged.PagedEngine(flax_params, dtype=jnp.float32,
                                                                             speculative=s, **CFG, **ENGINE)),
            ("port", params, wrong, lambda s: PagedEngine(params, dtype="float32", device="cpu", speculative=s,
                                                          **CFG, **ENGINE))):
        s = dict(spec)
        if s.get("draft_params") == "wrong":
            s["draft_params"] = other
        with pytest.raises(ValueError, match=match):
            build(s)


# ---------------------------------------------------------------- the served component


@pytest.fixture(scope="module")
def lm_uri(tmp_path_factory, flax_params):
    path = tmp_path_factory.mktemp("spec_lm") / "lm.msgpack"
    path.write_bytes(flax_serialization.to_bytes(jax.tree_util.tree_map(np.asarray, flax_params)))
    return f"file://{path}"


def _component(lm_uri, speculative):
    lm = StreamingLM(device="cpu", dtype="float32", model_uri=lm_uri, max_new_tokens=MAX_NEW, prefix_cache=False,
                     speculative=speculative, **CFG, **ENGINE)
    lm.load()
    return lm


def test_streaminglm_speculative_serves_streams_and_exports_its_gauges(lm_uri):
    prompts = _prompts("ngram")
    # the JAX side: its engine on the checkpoint its loader reads, in float32
    eng = jax_paged.PagedEngine(jax_load_lm_params(lm_uri, CFG, 0), dtype=jnp.float32, speculative=NGRAM,
                                prefix_cache=False, **CFG, **ENGINE)
    want = []
    for p in prompts:
        st = eng.submit(p, max_new_tokens=MAX_NEW)
        eng.run()
        want.append(st.result.tolist())
    eng.close()
    spec, plain = _component(lm_uri, NGRAM), _component(lm_uri, None)
    try:
        got = [spec.predict(p[None], [])[0].tolist() for p in prompts]
        assert got == want == [plain.predict(p[None], [])[0].tolist() for p in prompts]
        for p, row in zip(prompts, got):
            chunks = list(spec.predict_stream(p[None]))
            assert len(chunks) >= 1 and np.concatenate(chunks).tolist() == row
        keys = {m["key"]: m["value"] for m in spec.metrics() if not m.get("tags")}
        stats = spec.engine.engine_stats()
        assert keys["speculative_rounds"] == stats["chunks"] > 0
        assert keys["speculative_acceptance_rate"] == stats["spec_accepted"] / max(1, stats["spec_drafted"])
        assert "speculative_acceptance_rate" not in {m["key"] for m in plain.metrics()}
        health = spec.health_status()
        assert health["speculative"] == {"draft": "ngram", "draft_k": 3, "ngram": 2}
        assert plain.health_status()["speculative"] is None
        with pytest.raises(MicroserviceError) as err:
            spec.predict(prompts[0][None], [], {"tags": {"temperature": 0.7}})
        assert err.value.status_code == 400 and "greedy-exact" in str(err.value)
    finally:
        spec.unload()
        plain.unload()
